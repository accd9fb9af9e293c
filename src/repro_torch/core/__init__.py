from repro_torch.core.api import (SkyBuffer, SkyConfig, SkylineState,
                                  finalize, init_state, insert_chunk,
                                  parallel_skyline, skyline,
                                  skyline_mask_exact)
from repro_torch.core.sfs import (block_sfs, compact, naive_skyline_mask,
                                  skyline_mask)

__all__ = [
    "SkyBuffer", "SkyConfig", "SkylineState", "parallel_skyline", "skyline",
    "skyline_mask_exact", "init_state", "insert_chunk", "finalize",
    "block_sfs", "compact", "naive_skyline_mask", "skyline_mask",
]
