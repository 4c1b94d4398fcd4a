"""Import-side-effect activation: ``import nvshare_tpu_torch.autoload``.

The port of ``nvshare_tpu/autoload.py``, the moral equivalent of the
reference's LD_PRELOAD injection for Python processes: one import gates
the program's device ops (:func:`nvshare_tpu_torch.interpose.enable`), and
thereby registers with the scheduler on first device use. It gates the
card (``cuda``): without one the import raises, as every entry point
does. Controlled by env:

  * ``TPUSHARE_DISABLE=1`` — do nothing (escape hatch).
"""

import os

if os.environ.get("TPUSHARE_DISABLE") != "1":
    from nvshare_tpu_torch import interpose

    interpose.enable()
