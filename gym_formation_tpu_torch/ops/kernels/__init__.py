"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and its
launch counter; the CUDA sources are under ``gym_formation_tpu_torch/csrc/``
and are built by :mod:`gym_formation_tpu_torch.ops._build`.
"""

from . import (
    pairforce_sym, reward_sym, fused_step, fused_rollout, fused_collect, fused_ppo_grad,
    pairforce, reward, pairforce_cull, step_reset,
)

__all__ = ["pairforce_sym", "reward_sym", "fused_step", "fused_rollout", "fused_collect",
           "fused_ppo_grad", "pairforce", "reward", "pairforce_cull", "step_reset"]
