from timeopt.ops.linalg import (
    sym,
    gj_inv,
    gj_solve,
    gj_inv_pivots,
    psd_inv,
    psd_solve,
    spd_check,
    as_terminal_weight,
)
from timeopt.ops.wrap import angle_normalize, wrap_error

__all__ = [
    "sym",
    "gj_inv",
    "gj_solve",
    "gj_inv_pivots",
    "psd_inv",
    "psd_solve",
    "spd_check",
    "as_terminal_weight",
    "angle_normalize",
    "wrap_error",
]
