"""The flagship's training step for the port's profiling tools
(``xprof_capture``, ``step_breakdown``, ``cost_analysis``) and its MFU
sweep (``mfu_sweep``).

The configuration is the flagship dense model at its training widths:
vocab 32000, d_model 2048, 16 heads of 128, 8 layers, d_ff 8192 (468M
parameters), bf16 compute over f32 parameters, batch 16 × 1024 tokens,
the loss in chunks of 256 positions, ``remat="dots"``, AdamW at lr 1e-3.
Attention is ``"flash"``: the port's flash forward and, with
``ops_flash_bwd_kernel`` on, its dq and dk/dv kernels run on the card
(16 / 8 / 8 launches a step: 8 forwards, 8 recomputed under remat).
On the CPU the same wrappers run their plain versions.  A sweep row
passes the ``TransformerConfig`` fields it sets (``ROW_FIELDS``); a
tool's ``--layers`` cuts the depth and keeps the widths (:func:`cut`).

``peak_flops``/``hbm_bw`` give an NVIDIA H100's dense bf16 tensor-core
peak (989e12 FLOP/s) and HBM rate (3.35e12 B/s) by the card's name, and
None for any other device: a tool records no bound where it has no
peak.  The tools' outputs go under ``build/ompi_tpu_torch/`` of the
checkout (gitignored).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import threading
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
#: the ``TransformerConfig`` fields a sweep row may set (the reference's
#: ``tools/mfu_sweep.py`` rows set these)
ROW_FIELDS = ("seq", "ce_chunk", "remat", "attention", "adam_mu_dtype",
              "param_dtype", "grad_accum")

#: (name fragment, dense bf16 FLOP/s, HBM bytes/s): NVIDIA's data sheet
#: for the H100 SXM part at its 700 W limit
_PEAKS = (("H100", 989e12, 3.35e12),)


def config(small: Optional[dict] = None, batch: Optional[int] = None,
           **fields):
    """(TransformerConfig, batch) of the flagship train step; ``small``
    (a dict of widths, ``seq`` and ``ce_chunk``) replaces the widths for
    a CPU run, ``batch`` the batch, and ``fields`` (any of
    ``ROW_FIELDS``) the step's options: flash attention, ``remat="dots"``
    and bf16 compute unless a field says otherwise.  Where ``small`` sets
    ``seq`` the sequence stays ``small``'s: a row's ``seq`` is a width
    (``cut(None, layers)`` sets only the depth, so a row keeps its
    sequence)."""
    from ompi_tpu_torch.models.transformer import TransformerConfig

    bad = sorted(set(fields) - set(ROW_FIELDS))
    if bad:
        raise ValueError(f"not a row field: {bad}; one of {ROW_FIELDS}")
    if small and "seq" in small:
        fields.pop("seq", None)
    widths = dict(FLAGSHIP, seq=TRAIN["seq"], ce_chunk=TRAIN["ce_chunk"])
    widths.update(small or {})
    opts = dict(attention="flash", compute_dtype="bfloat16", remat="dots")
    cfg = TransformerConfig(**{**widths, **opts, **fields})
    return cfg, int(batch or TRAIN["batch"])


def cut(small: Optional[dict], layers: Optional[int]) -> Optional[dict]:
    """:func:`config`'s ``small`` for a tool's ``--small`` and
    ``--layers``: ``small`` (None: the flagship's widths) at ``layers``
    of depth, the widths unchanged; ``small`` itself without
    ``layers``."""
    if layers is None:
        return small
    if layers < 1:
        raise ValueError(f"--layers takes a depth of 1 or more, got {layers}")
    return dict(small or {}, n_layers=layers)


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


def _import_quietly(name: str) -> None:
    try:
        importlib.import_module(name)
    except Exception:  # noqa: BLE001 — the first real use imports it again
        pass


@contextlib.contextmanager
def importing_dynamo():
    """Import ``torch._dynamo`` on a thread while the block runs (a numpy
    draw, which releases the GIL): ``torch.utils.checkpoint`` (remat,
    the chunked loss) imports it at its first call, most of a fresh
    process's first training step otherwise.  The block must import
    nothing itself."""
    th = threading.Thread(target=_import_quietly, args=("torch._dynamo",),
                          daemon=True)
    th.start()
    try:
        yield
    finally:
        th.join()


def draw(small: Optional[dict] = None, batch: Optional[int] = None,
         **fields):
    """The host half of :func:`build`: (cfg, batch, the parameters from
    ``init_params`` seed 0 as numpy, one batch of tokens drawn with numpy
    seed 0); touches no device.  ``fields`` as :func:`config`'s.
    ``torch._dynamo`` is imported meanwhile (:func:`importing_dynamo`)."""
    from ompi_tpu_torch.models.transformer import init_params

    cfg, batch = config(small, batch, **fields)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(batch, cfg.seq)).astype(np.int32)
    with importing_dynamo():
        params = init_params(cfg)
    return cfg, batch, params, toks


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


def flash_module():
    """The port's flash module (``ompi_tpu_torch.ops.flash_attention`` as
    an attribute of ``ops`` is the function of that name); importing it
    registers the ``ops_flash_*`` variables."""
    import importlib

    return importlib.import_module("ompi_tpu_torch.ops.flash_attention")


def flash_counts() -> dict:
    """The flash kernels' launch counters."""
    fa = flash_module()
    return {"flash_fwd": fa.launch_count, "flash_bwd_dq": fa.dq_launch_count,
            "flash_bwd_dkv": fa.dkv_launch_count}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
