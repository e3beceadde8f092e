"""Device and factor precision of the port.

The device is always named by the caller: ``resolve_device`` never falls
back from a missing card to the CPU. The factor precision is float64 (the
production precision, the reference's own) or float32 (the fast path that
the refiner tries first under "auto", escalating to float64 when it
fails); ``resolve_precision`` maps the caller's spec to a torch dtype.
``card_name`` reads the card's name and power limit, which every time the
port reports stands beside.
"""

from __future__ import annotations

import subprocess

import torch

PRECISIONS = {"f32": torch.float32, "f64": torch.float64}


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch.device for ``name``: "cuda" (or "cuda:<i>") when a card is
    present, raising when none is; "cpu" only when the caller names it.

    For CUDA it also keeps every float32 product in full float32: TF32
    (about three decimal digits) would wreck a direct solver's float32
    factors and refinement cycles, as bf16 passes would on the TPU, where
    the JAX package runs under default_matmul_precision("highest")."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r} (expected cuda or "
                         f"cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA device "
                           f"is available")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {name!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) "
                           f"exist")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev


def resolve_precision(spec: str | None,
                      device: torch.device) -> torch.dtype:
    """The factor dtype for ``spec``: "f32", "f64", or "auto"/None.
    "auto" follows the JAX engine's rule (mf_jax.JaxMultifrontal): float32
    first on the accelerator, with the facade escalating to float64 when
    refinement fails; float64 on the CPU."""
    if spec is None or spec == "auto":
        return torch.float32 if device.type == "cuda" else torch.float64
    if spec not in PRECISIONS:
        raise ValueError(f"unknown precision {spec!r} (expected f32, f64 or "
                         f"auto)")
    return PRECISIONS[spec]


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for
    ``device``'s card ("cpu" on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    smi = subprocess.run(["nvidia-smi", f"--id={index}",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed (rc {smi.returncode}): "
                           f"{smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]
