"""Small shared utilities (logging, env config, byte-size helpers)."""

from nvshare_tpu_torch.utils.log import get_logger  # noqa: F401
from nvshare_tpu_torch.utils.config import (  # noqa: F401
    env_bool,
    env_bytes,
    env_float,
    env_int,
)
