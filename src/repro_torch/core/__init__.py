from repro_torch.core.api import (SkyBuffer, SkyConfig, parallel_skyline,
                                  skyline, skyline_mask_exact)
from repro_torch.core.sfs import block_sfs, compact, naive_skyline_mask

__all__ = [
    "SkyBuffer", "SkyConfig", "parallel_skyline", "skyline",
    "skyline_mask_exact", "block_sfs", "compact", "naive_skyline_mask",
]
