"""xllm_tpu_torch: the PyTorch/CUDA port of ``xllm_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout (``config/``, ``framework/``,
``scheduler/``, ``ops/``, ``models/``, ``runtime/``, ``engine.py``,
``llm.py``) so every module has an obvious counterpart there. Plain tensor
work is PyTorch; every Pallas kernel on the served path is a hand-written
Hopper kernel under ``csrc/`` (built with nvcc for sm_90a on first use, see
``ops/cuda/_build.py``). It imports neither jax nor ``xllm_tpu``.

The entry points (``LLMEngine``, ``LLM``, ``ModelRunner``) run on the card
unless the caller passes ``device="cpu"``; on CPU tensors every kernel
wrapper takes its plain PyTorch version.
"""

import torch as _torch

__version__ = "0.1.0"

# float32 products run in full float32 on the card, as the JAX reference's
# "highest" precision does; TF32 would keep about three decimal digits
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
