"""Global configuration for safeopt_torch.

Counterpart of ``safeopt_tpu/config.py``. The port is dtype-polymorphic
like the JAX package: the default compute dtype follows the device a
model lives on — float64 on the CPU (where the parity tests run, like
x64 in the JAX tests) and float32 on CUDA (like f32 on the TPU). The
entry points default to the card (``device='cuda'``) and run on the CPU
only when the caller asks for it; no default depends on what hardware is
present, and nothing moves between devices implicitly.

Decision-path products run at full float32 on the card. PyTorch's
float32 matrix products may use TF32 (about three decimal digits) when
``allow_tf32`` is set, and cuDNN's do by default; safe-set membership
is an interval comparison, so both are switched off here — the
counterpart of ``MATMUL_PRECISION = "highest"`` in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["default_dtype", "JITTER"]

# Jitter added to prior covariances (reference utilities.py:89 adds
# 1e-6 * I); kept for parity with the JAX package's config.
JITTER = 1e-6

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_dtype(device) -> torch.dtype:
    """Default floating dtype for tensors on ``device``: float64 on the
    CPU, float32 on an accelerator."""
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32
