"""gaussian's binding: the port's iterated 3x3 stencil chain
(``repro_torch.apps.gaussian``), built once; the harness writes the frame
into the ``img`` mmap and reads the ``result`` mmap back."""

import contextlib

import torch


def build(cfg: dict, device: torch.device):
    from repro_torch.apps import gaussian
    if cfg["form"] != "step":
        raise ValueError(f"gaussian has no form {cfg['form']!r}")
    top, args, _ = gaussian.build_step(device=device, **cfg["params"])
    return top, args


def load(args, inp: dict) -> None:
    args[0].data.copy_(inp["img"])


def outputs(args) -> list:
    return [args[1].data]


def output(args) -> torch.Tensor:
    return args[1].data


@contextlib.contextmanager
def control(cfg: dict, ref):
    """The lower-precision control: the reference computed in bfloat16
    writes the output in the program's place (the configuration states
    float32; the port has no bfloat16 path of its own)."""
    def invoke(top, args):
        out = ref.reference(cfg, {"img": args[0].data}, torch.bfloat16)
        args[1].data.copy_(out)
        return None, None
    yield invoke
