"""gemm's binding: the port's systolic GEMM (``repro_torch.apps.gemm``),
built once; the harness writes A and B into the buffers the builder bound
and reads C back from them.

``step``: A and B are plain ``mmap``s, C is written through one mmap view
a row of blocks.  ``step_async``: each row of A blocks sits behind an
``async_mmap`` read port (``[K, n, n]``, block ``k`` of row ``i``), B is a
plain mmap, and each row of C blocks leaves through an ``async_mmap``
write port (``[P, n, n]``).
"""

import contextlib

import torch


def build(cfg: dict, device: torch.device):
    from repro_torch.apps import gemm
    builders = {"step": gemm.build_step, "step_async": gemm.build_step_async}
    if cfg["form"] not in builders:
        raise ValueError(f"gemm has no form {cfg['form']!r}")
    top, args, _ = builders[cfg["form"]](device=device, **cfg["params"])
    return top, args


def _async(args) -> bool:
    return isinstance(args[1], list)


def load(args, inp: dict) -> None:
    A, B = inp["A"], inp["B"]
    if not _async(args):
        args[0].data.copy_(A)
        args[1].data.copy_(B)
        return
    args[0].data.copy_(B)
    for i, port in enumerate(args[1]):
        K, n, _ = port.data.shape
        port.data.copy_(A[i * n:(i + 1) * n].reshape(n, K, n)
                        .transpose(0, 1))


def outputs(args) -> list:
    if not _async(args):
        return [m.data for m in args[2]]
    return [p.data for p in args[2]]


def output(args) -> torch.Tensor:
    """C as one ``[P*n, P*n]`` tensor."""
    if not _async(args):
        return torch.cat([m.data for m in args[2]])
    return torch.cat([torch.cat(list(p.data), dim=1) for p in args[2]])


@contextlib.contextmanager
def control(cfg: dict, ref):
    """The lower-precision control: the port's own products with TF32 on
    (the configuration states float32 with TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield None
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
