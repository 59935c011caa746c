"""Full-f32 matmul precision for the solve path: TF32 off.

The reduced J coupling is a moments -> region-algebra -> expand chain of
small matrix products.  Rounding the J side and the J^T side independently
makes the assembled operator asymmetric and CG stalls: on jelly_jam 32^3
the JAX package measured a PCG residual of 0.77 after 10 iterations at
reduced matmul precision against 1.6e-9 at full precision
(``polystokes_tpu/precision.py``).  TF32 keeps about three decimal digits,
the same trap on Hopper, so importing the package turns it off for
matrix products and for cuDNN.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Run float32 matrix products in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
