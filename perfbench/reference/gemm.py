"""gemm's plain reference and its work: ``C = A @ B``.

Plain PyTorch on the harness's own copies of the inputs, in float64 (the
configuration states float32 with TF32 off; float64 is above it).
"""

import torch


def reference(cfg: dict, inp: dict, dtype=torch.float64) -> torch.Tensor:
    return inp["A"].to(dtype) @ inp["B"].to(dtype)


def work(cfg: dict) -> dict:
    """The operations and bytes one invocation needs, from the shapes:
    ``2 M N K`` multiply-adds' operations; A and B read once and C
    written once, in float32."""
    p = cfg["params"]
    m = n = p["P"] * p["n"]
    k = p["K"] * p["n"]
    return {"flops": 2 * m * n * k, "bytes": 4 * (m * k + k * n + m * n)}
