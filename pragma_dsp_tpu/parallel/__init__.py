"""Multi-chip SPMD layer: meshes, distributed FFT, sharded pipelines.

All communication is XLA collectives over the mesh (ppermute halos,
all_to_all corner turns, psum reductions) — see SURVEY.md §5.
"""

from .dist_fft import (
    dist_fft,
    dist_fft_shape,
    dist_ifft,
    permuted_to_natural_host,
)
from .mesh import Mesh, NamedSharding, P, data_mesh, make_mesh
from .multihost import (BarrierTimeout, barrier, health_check,
                        init_multihost, is_multihost)
from .sharded import (
    sharded_channel_power,
    sharded_fir_filter,
    sharded_pfb_channelize,
    sharded_pfb_channelize_frames,
    sharded_resample_poly,
    sharded_spectrogram,
    sharded_upfirdn,
    sharded_wbfm_demod,
)

__all__ = [
    "Mesh",
    "NamedSharding",
    "P",
    "data_mesh",
    "make_mesh",
    "dist_fft",
    "dist_ifft",
    "dist_fft_shape",
    "permuted_to_natural_host",
    "sharded_channel_power",
    "sharded_fir_filter",
    "sharded_pfb_channelize",
    "sharded_pfb_channelize_frames",
    "sharded_resample_poly",
    "sharded_spectrogram",
    "sharded_upfirdn",
    "sharded_wbfm_demod",
    "BarrierTimeout",
    "barrier",
    "health_check",
    "init_multihost",
    "is_multihost",
]
