"""Serving traffic: a closed loop of whole-batch greedy generation calls.

Each call hands the program's decoder (``make_decoder``) a fresh batch
of ``batch`` prompts of ``prompt`` tokens, drawn uniformly from the
vocabulary on the device from (seed, call), and takes back
``new_tokens`` greedy tokens a prompt: the first from the prefill, the
rest from the cached steps.  Set-up makes the weights from the seed and
warms with one whole call on a prompt batch of its own.  After the
window a sample of ``checked_requests`` finished requests, drawn from
the seed, is judged by the reference: the widest gap by which a served
token's logit lies below the reference's best at its position.

The mix's keys: ``kind`` ("decode"), ``batch``, ``prompt``,
``new_tokens``, ``checked_requests``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import checks, reference, weights


def program_config(model: dict, serve: dict, seq: int):
    from ompi_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab=model["vocab"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_layers=model["n_layers"],
        d_ff=model["d_ff"], seq=seq, attention=serve["attention"],
        moe_experts=model.get("moe_experts", 0),
        moe_capacity_factor=model.get("moe_capacity_factor", 1.25),
        moe_aux_weight=model.get("moe_aux_weight", 0.01),
        compute_dtype=serve["compute_dtype"])


def prompts(seed: int, call: int, batch: int, length: int, vocab: int,
            device) -> torch.Tensor:
    """The prompts of call ``call`` (−1: the warm-up's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_033 + call + 1) % (2 ** 63))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)


class Session:
    RATE = "decode_tokens_per_s"
    #: the harness's spans in a traced run (``benchmark.spans``)
    SPANS = ("attention", "prefill", "step_layer")

    def __init__(self, cell, seed: int, device):
        self.model = cell.config["model"]
        self.serve = cell.config["serve"]
        self.mix = cell.mix
        self.seed, self.dev = int(seed), device
        self.B = int(cell.mix["batch"])
        self.Tp = int(cell.mix["prompt"])
        self.new = int(cell.mix["new_tokens"])
        self.outs: list = []
        self.pending: list = []

    def _prompts(self, call: int) -> torch.Tensor:
        return prompts(self.seed, call, self.B, self.Tp,
                       self.model["vocab"], self.dev)

    def setup(self, warm: bool = True) -> None:
        from ompi_tpu_torch.models.decode import make_decoder
        from ompi_tpu_torch.models.weights import from_jax_params
        from ompi_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh({"dp": 1, "sp": 1, "tp": 1}, device=self.dev)
        cfg = program_config(self.model, self.serve, self.Tp + self.new)
        drawn = weights.make(self.model, self.seed, self.dev)
        self.params = from_jax_params(drawn, cfg, self.dev)
        del drawn
        self.decoder = make_decoder(cfg, mesh, max_new=self.new)
        if warm:
            self.decoder(self.params, self._prompts(-1))

    def _call(self) -> None:
        self.pending.append(self.decoder(self.params,
                                         self._prompts(len(self.outs)
                                                       + len(self.pending))))

    def window(self, seconds: float, t0: float) -> dict:
        n = 0
        while True:
            self._call()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return {"calls": n, "tokens": n * self.B * self.new}

    def traced_window(self) -> dict:
        self._call()
        return {"calls": 1, "tokens": self.B * self.new,
                "cached_steps": self.new - 1}

    def outcome(self) -> dict:
        """Requests of the window, and those whose answer is malformed
        (a length or a token out of range)."""
        bad, n = 0, 0
        for out in self.pending:
            n += out.shape[0]
            if tuple(out.shape) != (self.B, self.Tp + self.new):
                bad += out.shape[0]
                continue
            bad += int(((out < 0) | (out >= self.model["vocab"])).any(
                dim=1).sum())
            self.outs.append(out.cpu())
        self.pending = []
        return {"attempted": n, "failed": bad}

    def free(self) -> None:
        del self.params, self.decoder
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------
    def sample(self) -> list:
        """(call, row) of the requests judged, drawn from the seed."""
        total = len(self.outs) * self.B
        k = min(int(self.mix["checked_requests"]), total)
        picks = np.random.default_rng((self.seed, 1)).choice(total, k,
                                                             replace=False)
        return [(int(i) // self.B, int(i) % self.B) for i in sorted(picks)]

    def judged(self):
        """(the sampled requests' whole token rows (k, Tp + new), the
        prompts the harness sent them)."""
        rows, sent = [], []
        by_call: dict = {}
        for call, row in self.sample():
            by_call.setdefault(call, []).append(row)
        for call, rs in sorted(by_call.items()):
            p = self._prompts(call)
            for r in rs:
                rows.append(self.outs[call][r].to(self.dev).long())
                sent.append(p[r])
        return torch.stack(rows), torch.stack(sent)

    def reference_logits(self, tokens, precision: str = "f32"):
        params = weights.make(self.model, self.seed, self.dev)
        try:
            return reference.next_token_logits(self.model, params, tokens,
                                               self.Tp, precision)
        finally:
            del params

    def check(self) -> dict:
        tokens, sent = self.judged()
        logits = self.reference_logits(tokens)
        gap = checks.served_gap(logits, tokens[:, self.Tp:])
        if not torch.equal(tokens[:, :self.Tp], sent):
            gap = float("inf")      # the answer is not to the prompt sent
        return {"served_logit_gap": gap}
