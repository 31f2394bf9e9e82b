"""Training traffic: a closed loop of optimizer steps, back to back.

Each step takes a fresh global batch of ``batch`` × ``seq`` tokens, cut
by the program's own input pipeline (``ArraySource`` windows over a
corpus, ``train_stream``'s prefetch thread) from a corpus of
``corpus_tokens`` tokens drawn uniformly from the vocabulary with the
seed.  Set-up builds one training state (weights from the seed, AdamW)
and drives it through the first ``checked_steps`` steps with the
window's own call and feed; their losses, the first gradient (read from
the optimizer's first moment after step 1) and each parameter's change
(read before the window moves it again) are the program's side of the
check.  The window then runs on with the same state and stream.

The mix's keys: ``kind`` ("train"), ``batch``, ``seq``,
``corpus_tokens``, ``checked_steps``, ``traced_steps``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import checks, reference, weights

#: elements of each leaf's first gradient that both sides keep
SAMPLE = 1 << 20


def program_config(model: dict, train: dict, seq: int):
    from ompi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab=model["vocab"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_layers=model["n_layers"],
        d_ff=model["d_ff"], seq=seq, attention=train["attention"],
        moe_experts=model.get("moe_experts", 0),
        moe_capacity_factor=model.get("moe_capacity_factor", 1.25),
        moe_aux_weight=model.get("moe_aux_weight", 0.01),
        ce_chunk=train["ce_chunk"], compute_dtype=train["compute_dtype"],
        remat=train["remat"], param_dtype=train["param_dtype"])


def corpus(seed: int, vocab: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=size,
                                                dtype=np.int32)


def batch_rows(tokens: np.ndarray, seed: int, step: int, batch: int,
               seq: int) -> np.ndarray:
    """The global batch of step ``step``: ``batch`` windows of ``seq``
    tokens at starts drawn from (seed, step), wrapping round the
    corpus.  The reference's own copy of the windows the program's
    pipeline cuts."""
    n = tokens.size
    starts = np.random.default_rng((seed, step)).integers(0, n, size=batch)
    return tokens[(starts[:, None] + np.arange(seq)[None, :]) % n]


def _import_dynamo() -> None:
    import torch._dynamo  # noqa: F401 — the remat's first call needs it


class Session:
    RATE = "train_tokens_per_s"
    #: the harness's spans in a traced run (``benchmark.spans``)
    SPANS = ("attention", "optimizer", "moe")

    def __init__(self, cell, seed: int, device):
        self.model = cell.config["model"]
        self.train = cell.config["train"]
        self.optim = self.train["optimizer"]
        self.mix = cell.mix
        self.seed, self.dev = int(seed), device
        self.B, self.T = int(cell.mix["batch"]), int(cell.mix["seq"])
        self.losses: list = []

    # -- the program ---------------------------------------------------
    def setup(self) -> None:
        from ompi_tpu_torch.models.data import ArraySource, train_stream
        from ompi_tpu_torch.models.transformer import make_train_step
        from ompi_tpu_torch.models.weights import from_jax_params
        from ompi_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=self.dev)
        cfg = program_config(self.model, self.train, self.T)
        self.step, init = make_train_step(cfg, mesh, lr=self.optim["lr"])
        # torch.utils.checkpoint imports torch._dynamo at its first call;
        # import it meanwhile (the program's modules are imported by now)
        dyn = threading.Thread(target=_import_dynamo, daemon=True)
        dyn.start()
        self.corpus = corpus(self.seed, self.model["vocab"],
                             int(self.mix["corpus_tokens"]))
        drawn = weights.make(self.model, self.seed, self.dev)
        self.params = from_jax_params(drawn, cfg, self.dev, train=True,
                                      mesh=mesh)
        del drawn
        self.opt = init(self.params)
        self.stream = train_stream(ArraySource(self.corpus, self.seed), mesh,
                                   self.B, self.T)
        dyn.join()
        self.sample = {k: self._sample_index(k, p.numel())
                       for k, p in self.params.items()}
        losses, first, self.routes = [], None, []
        for i in range(int(self.mix["checked_steps"])):
            self._checked_step()
            losses.append(self.losses.pop())
            if i == 0:
                first = self._first_grads()
        self.program = {"losses": [float(x) for x in losses], **first,
                        "change_norms": self._change_norms(self._live())}

    def _checked_step(self) -> None:
        """A step of the window's own call and feed; an MoE config's
        routing is taken from the program's records of it, each layer's
        forward call (the first with its key) in order."""
        if not self.model.get("moe_experts"):
            self._one()
            return
        from ompi_tpu_torch.parallel import moe

        with moe.recording() as records:
            self._one()
        first: dict = {}
        for r in records:
            first.setdefault(r["key"], r["expert"])
        self.routes.append(list(first.values()))

    def _one(self) -> None:
        self.params, self.opt, loss = self.step(self.params, self.opt,
                                                next(self.stream))
        self.losses.append(loss)

    def _adam(self):
        return self.opt["opt"] if isinstance(self.opt, dict) else self.opt

    def _live(self) -> dict:
        """The f32 parameters the optimizer moves (a master copy where the
        program keeps one)."""
        if isinstance(self.opt, dict) and "master" in self.opt:
            return self.opt["master"]
        return self.params

    def _sample_index(self, leaf: str, n: int) -> torch.Tensor:
        if n <= SAMPLE:
            return torch.arange(n, device=self.dev)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(weights.leaf_seed(self.seed, leaf, self.model) + 1)
        return torch.randint(0, n, (SAMPLE,), generator=gen, device=self.dev)

    def _first_grads(self) -> dict:
        """After step 1 the first moment is (1 − b1)·g: each leaf's
        gradient norm, and its sampled elements."""
        keep = 1 / (1 - self.optim["b1"])
        mu = self._adam().mu
        return {"grad_norms": {k: float(m.detach().float().norm()) * keep
                               for k, m in mu.items()},
                "grad_samples": {k: m.detach().float().reshape(-1)[
                    self.sample[k]] * keep for k, m in mu.items()}}

    def _change_norms(self, params: dict) -> dict:
        out = {}
        for k, p in params.items():
            p0 = weights.leaf(self.model, self.seed, k, self.dev)
            out[k] = float((p.detach().float() - p0).norm())
            del p0
        return out

    def window(self, seconds: float, t0: float) -> dict:
        n = 0
        while True:
            self._one()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return {"steps": n, "tokens": n * self.B * self.T}

    def traced_window(self) -> dict:
        n = int(self.mix["traced_steps"])
        for _ in range(n):
            self._one()
        return {"steps": n, "tokens": n * self.B * self.T}

    def outcome(self) -> dict:
        """Steps attempted in the window, and those whose loss is not
        finite."""
        if not self.losses:
            return {"attempted": 0, "failed": 0}
        bad = int((~torch.isfinite(torch.stack(self.losses))).sum())
        n = len(self.losses)
        self.losses = []
        return {"attempted": n, "failed": bad}

    def free(self) -> None:
        self.stream.close()
        del self.params, self.opt, self.step, self.stream
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------
    def reference(self, precision: str = "f32", follow="program") -> dict:
        """The reference's side: the same weights and batches, the checked
        steps in ``precision``; an MoE config's switch follows the
        routing of ``follow`` ("program": the program's checked steps; a
        list: another side's; None: its own), judging each choice."""
        if follow == "program":
            follow = self.routes if self.model.get("moe_experts") else None
        params = weights.make(self.model, self.seed, self.dev)
        batches = (torch.from_numpy(batch_rows(
            self.corpus, self.seed, s, self.B, self.T)).to(self.dev)
            for s in range(int(self.mix["checked_steps"])))
        out = reference.train(self.model, self.optim, params, batches,
                              self.T, precision, self.sample, follow)
        out["change_norms"] = self._change_norms(params)
        del params
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def numbers(self, side: dict, ref: dict) -> dict:
        """The numbers compared, of ``side`` (the program's, or the
        control's) against the reference's."""
        sizes = {k: weights.numel(self.model, k) for k in self.sample}
        out = {**checks.train_numbers(side, ref),
               "grad_diff": checks.grad_diff(side, ref, sizes)}
        if self.model.get("moe_experts"):
            # the first step's routing: from the second step on, AdamW's
            # sign-like first updates part the two sides' gate weights by
            # rounding, and the reference follows without judging
            out["route_gap"] = ref["route_gap"]
        return out

    def check(self) -> dict:
        return self.numbers(self.program, self.reference())
