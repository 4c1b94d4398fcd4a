"""Workload models of the port: the co-location burners."""

from nvshare_tpu_torch.models.burner import (  # noqa: F401
    AddBurner,
    MatmulBurner,
    MixBurner,
)
