"""tpu_gnss — GPS L1 C/A software receiver framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of the
reference GNSS-GPS-SDR toolkit (JiaoXianjun/GNSS-GPS-SDR): signal synthesis,
FFT acquisition, DLL/Costas tracking, NAV/ephemeris decode, PVT solve, and
capture-format tooling — batched over (PRN x Doppler x block) grids and
sharded across device meshes instead of serial CPU loops and FPGA channels.
"""

from . import constants
from .config import ReceiverConfig, PRESETS

__version__ = "0.1.0"
__all__ = ["constants", "ReceiverConfig", "PRESETS", "__version__"]
