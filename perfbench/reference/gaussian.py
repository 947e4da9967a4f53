"""gaussian's plain reference and its work: ``iters`` passes of the 3x3
Gaussian kernel ``[[1, 2, 1], [2, 4, 2], [1, 2, 1]] / 16`` over an
``h x w`` frame.  The boundary rule is the app's documented one: the
first and last rows and the first and last columns are emitted as they
are; every other pixel is its window's weighted sum.

Plain PyTorch on the harness's own copy of the frame, in float64 (the
configuration states float32).
"""

import torch

WEIGHTS = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def reference(cfg: dict, inp: dict, dtype=torch.float64) -> torch.Tensor:
    p = cfg["params"]
    h, w = p["h"], p["w"]
    img = inp["img"].to(dtype)
    for _ in range(p["iters"]):
        acc = torch.zeros((h - 2, w - 2), dtype=dtype, device=img.device)
        for dy in range(3):
            for dx in range(3):
                acc += (WEIGHTS[dy][dx] / 16.0) * \
                    img[dy:h - 2 + dy, dx:w - 2 + dx]
        img = img.clone()
        img[1:-1, 1:-1] = acc
    return img


def work(cfg: dict) -> dict:
    """The operations and bytes one invocation needs, from the shapes: 9
    multiplies and 8 adds an interior pixel a pass; the frame read once and
    the result written once, in float32."""
    p = cfg["params"]
    h, w = p["h"], p["w"]
    return {"flops": 17 * (h - 2) * (w - 2) * p["iters"],
            "bytes": 4 * 2 * h * w}
