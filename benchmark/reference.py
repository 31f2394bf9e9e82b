"""The plain reference: the flagship transformer and its switch MoE in
float32 PyTorch, with its loss, gradients and AdamW, and no kernel, no
cache and no batching trick.  It imports nothing of the program.

The model, as the configuration states it: a tied embedding; per layer
RMSNorm (eps 1e-6) → q, k, v projections → rotary embeddings on q and k
(base 10000, the two halves of a head rotated) → causal softmax
attention (scale hd^-1/2) → output projection and residual; RMSNorm → a
tanh-GELU MLP, or the top-1 switch (gate softmax, the first of equal
probabilities, capacity ceil(n/E · factor) kept in token order, the rest
dropped to the residual, the output scaled by the gate probability, the
balance loss E · Σ_e f_e · p_e) → residual; a final RMSNorm and the tied
unembedding.  The loss is the mean next-token cross entropy over
positions 0 … seq−2 (the label of position t is token t+1), plus the
balance-loss weight times the layers' summed balance loss.

``precision="fp8"`` is the control, the precision below the
configuration's bfloat16 wherever the program holds bfloat16: every
matrix product's operands and the residual stream rounded to float8
e4m3 (one scale a tensor, its largest magnitude at 448), the products
and the rest in f32.  Memory: each layer is recomputed in the backward and the
loss is taken in chunks of tokens, so a whole training batch fits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
#: tokens of one chunk of the loss (its logits live only in the chunk)
LOSS_CHUNK = 4096


def exact_f32() -> None:
    """f32 products in full f32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at one scale for the tensor, as f32; the
    gradient passes straight through."""
    d = x.detach()
    scale = d.abs().amax().clamp_min(1e-30) / 448.0
    q = (d / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - d)


def stored(x, precision: str):
    """x as the residual stream holds it in ``precision``."""
    if precision == "fp8":
        return _fp8(x)
    if precision != "f32":
        raise ValueError(f"precision is f32 or fp8, not {precision!r}")
    return x


def matmul(a, b, precision: str = "f32"):
    return torch.matmul(stored(a, precision), stored(b, precision))


def rmsnorm(x, scale, eps: float = 1e-6):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x, base: float = 10_000.0):
    """x (B, T, H, hd) at positions 0 … T−1."""
    T, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (base ** (torch.arange(half, dtype=F32, device=x.device)
                            / half))
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, precision: str):
    """Causal softmax attention, (B, T, H, hd) each → (B, T, H, hd)."""
    T, hd = q.shape[1], q.shape[-1]
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = matmul(qh, kh.transpose(-1, -2), precision) * hd ** -0.5
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return matmul(p, vh, precision).permute(0, 2, 1, 3)


class Routes:
    """The experts each layer's switch chose in one forward pass, and,
    where ``fixed`` gives the choices of the side being judged, how far
    below the best gate probability here each of its choices lies.  A
    recomputed layer routes as its forward did."""

    def __init__(self, fixed=None):
        self.fixed = fixed
        self.chosen: dict = {}
        self.gap = 0.0

    def choose(self, i: int, probs):
        if i in self.chosen:
            return self.chosen[i]
        best = probs.argmax(dim=-1)
        fixed = self.fixed if self.fixed is not None else []
        want = fixed[i] if i < len(fixed) else None
        if want is None or want.shape != best.shape:
            if self.fixed is not None:      # no choice for these tokens
                self.gap = math.inf
            expert = best
        else:
            expert = want.to(best.device, torch.long)
            lost = probs.max(dim=-1).values - probs.gather(
                1, expert[:, None])[:, 0]
            self.gap = max(self.gap, float(lost.max()))
        self.chosen[i] = expert.detach()
        return self.chosen[i]


def switch(model: dict, x, wg, w1, w2, precision: str, expert):
    """Top-1 switch over the whole batch's tokens: x (n, D) → (y, aux);
    ``expert`` a callable of the gate probabilities that gives each
    token's expert."""
    n, E = x.shape[0], wg.shape[-1]
    probs = torch.softmax(matmul(x, wg, precision), dim=-1)
    expert = expert(probs.detach())
    gate = probs.gather(1, expert[:, None])[:, 0]
    cap = max(1, math.ceil((n / E) * model["moe_capacity_factor"]))
    y = torch.zeros_like(x)
    for e in range(E):
        idx = torch.nonzero(expert == e)[:, 0][:cap]
        if idx.numel() == 0:
            continue
        h = F.gelu(matmul(x[idx], w1[e], precision), approximate="tanh")
        y = y.index_add(0, idx, matmul(h, w2[e], precision)
                        * gate[idx, None])
    frac = torch.bincount(expert, minlength=E).to(F32) / n
    aux = E * (frac * probs.mean(dim=0)).sum()
    return y, aux


def layer(model: dict, precision: str, h, lp: dict, i: int = 0,
          routes: Routes = None):
    """Layer ``i``: h (B, T, D) → (h, aux)."""
    B, T, D = h.shape
    H = model["n_heads"]
    x = rmsnorm(h, lp["ln1"])
    q, k, v = (matmul(x, lp[w], precision).reshape(B, T, H, D // H)
               for w in ("wq", "wk", "wv"))
    o = attention(rope(q), rope(k), v, precision).reshape(B, T, D)
    h = stored(h + matmul(o, lp["wo"], precision), precision)
    x = rmsnorm(h, lp["ln2"])
    if model.get("moe_experts"):
        routes = routes or Routes()
        y, aux = switch(model, x.reshape(B * T, D), lp["wg"], lp["w1"],
                        lp["w2"], precision,
                        lambda probs: routes.choose(i, probs))
        return stored(h + y.reshape(B, T, D), precision), aux
    y = F.gelu(matmul(x, lp["w1"], precision), approximate="tanh")
    zero = torch.zeros((), dtype=F32, device=h.device)
    return stored(h + matmul(y, lp["w2"], precision), precision), zero


def backbone(model: dict, params: dict, tokens, precision: str = "f32",
             recompute: bool = False, routes: Routes = None):
    """tokens (B, T) → (final-normed h (B, T, D), summed balance loss)."""
    routes = routes or Routes()
    keys = [k for k in params if k not in ("emb", "lnf")]
    h = stored(params["emb"][tokens.long()], precision)
    aux = torch.zeros((), dtype=F32, device=h.device)
    for i in range(model["n_layers"]):
        lp = {k: params[k][i] for k in keys}
        if recompute:
            h, a = checkpoint(layer, model, precision, h, lp, i, routes,
                              use_reentrant=False)
        else:
            h, a = layer(model, precision, h, lp, i, routes)
        aux = aux + a
    return rmsnorm(h, params["lnf"]), aux


def _nll_sum(h, emb, labels, weight, precision):
    logits = matmul(h, emb.t(), precision)
    lse = torch.logsumexp(logits, dim=-1)
    return ((lse - logits.gather(1, labels[:, None])[:, 0]) * weight).sum()


def loss(model: dict, params: dict, tokens, seq: int,
         precision: str = "f32", routes: Routes = None):
    """The mean next-token cross entropy (+ the weighted balance loss)."""
    B, T = tokens.shape
    tokens = tokens.long()
    h, aux = backbone(model, params, tokens, precision, recompute=True,
                      routes=routes)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).reshape(-1)
    weight = (torch.arange(T, device=tokens.device) < seq - 1).to(F32)
    weight = weight.expand(B, T).reshape(-1)
    hf = h.reshape(B * T, -1)
    total = torch.zeros((), dtype=F32, device=h.device)
    for i in range(0, B * T, LOSS_CHUNK):
        sl = slice(i, i + LOSS_CHUNK)
        total = total + checkpoint(_nll_sum, hf[sl], params["emb"],
                                   labels[sl], weight[sl], precision,
                                   use_reentrant=False)
    out = total / (B * max(0, min(T, seq - 1)))
    if model.get("moe_experts"):
        out = out + model["moe_aux_weight"] * aux
    return out


class AdamW:
    """AdamW: m = b1·m + (1−b1)·g, v = b2·v + (1−b2)·g², the bias
    corrections 1 − b^t, u = m̂ / (√v̂ + eps) + wd·p, p ← p − lr·u."""

    def __init__(self, params: dict, lr, b1, b2, eps, weight_decay):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            m = self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            v = self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            params[k].sub_(self.lr * (u + self.wd * params[k]))


def train(model: dict, optim: dict, params: dict, batches, seq: int,
          precision: str = "f32", sample: dict = None,
          follow: list = None) -> dict:
    """Steps of AdamW on ``batches`` (an iterable of (B, T) tokens) from
    ``params`` (float32 leaves, updated in place).  ``follow``: for each
    step, each layer's experts as the judged side chose them, which the
    switch takes where they are a choice for these tokens.  → {"losses":
    each step's loss, "grad_norms": each leaf's gradient norm at step 1,
    "grad_samples": the step-1 gradient's elements at ``sample``'s flat
    indices, by leaf, "routes": each step's experts by layer,
    "route_gaps": each step's largest gate probability lost to a followed
    choice, "route_gap": the first step's}."""
    exact_f32()
    for p in params.values():
        p.requires_grad_(True)
    opt = AdamW(params, optim["lr"], optim["b1"], optim["b2"],
                optim["eps"], optim["weight_decay"])
    keys = list(params)
    losses, grad_norms, routes, gaps = [], None, [], []
    for step, tokens in enumerate(batches):
        r = Routes(None if follow is None else
                   (follow[step] if step < len(follow) else []))
        value = loss(model, params, tokens, seq, precision, r)
        grads = dict(zip(keys, torch.autograd.grad(
            value, [params[k] for k in keys])))
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            picked = {k: grads[k].reshape(-1)[i].clone()
                      for k, i in (sample or {}).items()}
        losses.append(float(value.detach()))
        routes.append([r.chosen[i] for i in sorted(r.chosen)])
        gaps.append(r.gap)
        opt.step(params, grads)
        del grads, value
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": grad_norms,
            "grad_samples": picked, "routes": routes, "route_gaps": gaps,
            "route_gap": gaps[0] if gaps else 0.0}


@torch.no_grad()
def next_token_logits(model: dict, params: dict, tokens, start: int,
                      precision: str = "f32"):
    """The logits at positions start−1 … T−2 of ``tokens`` (B, T): the
    ones that choose tokens start … T−1.  → (B, T − start, V) f32."""
    exact_f32()
    h, _ = backbone(model, params, tokens, precision)
    return matmul(h[:, start - 1:-1], params["emb"].t(), precision)
