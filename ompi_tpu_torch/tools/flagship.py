"""The flagship's training step for the port's profiling tools
(``xprof_capture``, ``step_breakdown``, ``cost_analysis``).

The configuration is the flagship dense model at its training widths:
vocab 32000, d_model 2048, 16 heads of 128, 8 layers, d_ff 8192 (468M
parameters), bf16 compute over f32 parameters, batch 16 × 1024 tokens,
the loss in chunks of 256 positions, ``remat="dots"``, AdamW at lr 1e-3.
Attention is ``"flash"``: the port's flash forward and, with
``ops_flash_bwd_kernel`` on, its dq and dk/dv kernels run on the card
(16 / 8 / 8 launches a step: 8 forwards, 8 recomputed under remat).
On the CPU the same wrappers run their plain versions.

``peak_flops``/``hbm_bw`` give an NVIDIA H100's dense bf16 tensor-core
peak (989e12 FLOP/s) and HBM rate (3.35e12 B/s) by the card's name, and
None for any other device: a tool records no bound where it has no
peak.  The tools' outputs go under ``build/ompi_tpu_torch/`` of the
checkout (gitignored).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where the tools write (gitignored)
OUT_DIR = os.path.join(REPO, "build", "ompi_tpu_torch")
#: the step-time records of step_breakdown and cost_analysis
SWEEP = os.path.join(OUT_DIR, "MFU_SWEEP.jsonl")

#: the flagship dense model's widths (468M parameters)
FLAGSHIP = dict(vocab=32_000, d_model=2048, n_heads=16, n_layers=8,
                d_ff=8192)
#: its training batch: 16 sequences of 1024 tokens, the loss in chunks
#: of 256 positions
TRAIN = dict(batch=16, seq=1024, ce_chunk=256)
LR = 1e-3
#: the CPU smoke's widths and batch (the reference's xprof ``--small``)
SMALL = dict(vocab=512, d_model=128, n_heads=8, n_layers=2, d_ff=256,
             seq=64, ce_chunk=0)
SMALL_BATCH = 2

#: (name fragment, dense bf16 FLOP/s, HBM bytes/s): NVIDIA's data sheet
#: for the H100 SXM part at its 700 W limit
_PEAKS = (("H100", 989e12, 3.35e12),)


def config(small: Optional[dict] = None, batch: Optional[int] = None):
    """(TransformerConfig, batch) of the flagship train step; ``small``
    (a dict of widths, ``seq`` and ``ce_chunk``) replaces the widths for
    a CPU run, ``batch`` the batch."""
    from ompi_tpu_torch.models.transformer import TransformerConfig

    widths = dict(FLAGSHIP, seq=TRAIN["seq"], ce_chunk=TRAIN["ce_chunk"])
    widths.update(small or {})
    cfg = TransformerConfig(**widths, attention="flash",
                            compute_dtype="bfloat16", remat="dots")
    return cfg, int(batch or TRAIN["batch"])


def count_params(params: dict) -> int:
    """Elements of every parameter leaf (tensors or numpy arrays)."""
    return int(sum(int(np.prod(tuple(p.shape))) for p in params.values()))


def flops_per_token(cfg, n_params: int) -> float:
    """The model FLOPs of one training token: 6N for the parameters'
    products forward and backward, 12·L·D·S for attention's."""
    return 6 * n_params + 12 * cfg.n_layers * cfg.d_model * cfg.seq


def _peak(kind: str, i: int) -> Optional[float]:
    return next((p[i] for p in _PEAKS if p[0].lower() in kind.lower()), None)


def peak_flops(kind: str) -> Optional[float]:
    """Dense bf16 FLOP/s of the card named ``kind``, None if unknown."""
    return _peak(kind, 1)


def hbm_bw(kind: str) -> Optional[float]:
    """HBM bytes/s of the card named ``kind``, None if unknown."""
    return _peak(kind, 2)


def device(cpu: bool):
    """The tools' device: the card (raising where there is none), or the
    CPU when asked."""
    from ompi_tpu_torch.parallel.mesh import resolve_device

    return resolve_device("cpu" if cpu else "cuda")


def device_kind(dev) -> str:
    """The card's name, or ``cpu``."""
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@dataclasses.dataclass
class Step:
    """One flagship train step's parts on one device."""

    cfg: object
    batch: int
    mesh: object
    params: dict
    tokens: object
    n_params: int

    @property
    def kind(self) -> str:
        return device_kind(self.mesh.device)


def draw(small: Optional[dict] = None, batch: Optional[int] = None):
    """The host half of :func:`build`: (cfg, batch, the parameters from
    ``init_params`` seed 0 as numpy, one batch of tokens drawn with numpy
    seed 0); touches no device."""
    from ompi_tpu_torch.models.transformer import init_params

    cfg, batch = config(small, batch)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(batch, cfg.seq)).astype(np.int32)
    return cfg, batch, init_params(cfg), toks


def build(dev, small: Optional[dict] = None, batch: Optional[int] = None,
          drawn=None) -> Step:
    """The flagship's parameters as trainable leaves on ``dev``, its
    batch of tokens there, and the one-rank mesh (from ``drawn``, what
    :func:`draw` returned, or drawn now); the flash backward kernels
    switched on."""
    import torch

    from ompi_tpu_torch.core.config import var_registry
    from ompi_tpu_torch.models.weights import from_jax_params
    from ompi_tpu_torch.ops import flash_attention  # noqa: F401 — its vars
    from ompi_tpu_torch.parallel.mesh import make_mesh

    cfg, batch, params_np, toks = drawn or draw(small, batch)
    var_registry.set("ops_flash_bwd_kernel", True)
    mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=dev)
    params = from_jax_params(params_np, cfg, dev, train=True, mesh=mesh)
    tokens = torch.from_numpy(toks).to(dev)
    return Step(cfg, batch, mesh, params, tokens, count_params(params))


def flash_counts() -> dict:
    """The flash kernels' launch counters."""
    import importlib

    fa = importlib.import_module("ompi_tpu_torch.ops.flash_attention")
    return {"flash_fwd": fa.launch_count, "flash_bwd_dq": fa.dq_launch_count,
            "flash_bwd_dkv": fa.dkv_launch_count}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
