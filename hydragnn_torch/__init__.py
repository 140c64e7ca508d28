"""hydragnn_torch — the PyTorch/CUDA port of hydragnn_tpu.

The JAX package (``hydragnn_tpu``) is the reference; this package keeps its
module paths and public names so each counterpart is easy to find.  It
imports ``torch`` and never ``jax`` or anything of ``hydragnn_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`hydragnn_torch.utils.device.resolve_device`).
"""

from hydragnn_torch.run_prediction import run_prediction
from hydragnn_torch.run_training import run_training

__all__ = ["run_prediction", "run_training"]
