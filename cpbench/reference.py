"""The plain reference that decides ``correct``: training steps of the
configuration's reference model (``references/<name>.py``) in float32
with TF32 off, or, as the control, rounded to float8 e4m3 wherever the
port's step holds bf16 (:class:`Precision`).  Plain PyTorch; it imports
nothing of the port and takes nothing the port made: the benchmark hands
it the same weights (drawn from the seed) and the same rows (packed
order) it hands the port, and it builds each document's causal mask from
the rows' document lengths itself.

It fits the card by blocks: the layers are rematerialized one at a time
in the backward, the head's logits are made a block of rows at a time,
and the attention (:class:`DocAttention`) runs over one document and
one block of queries at a time, in the forward and again in the
backward.  The optimizer is the configuration's: clipping by the global
norm, the warmup-cosine learning rate, AdamW with bias correction and
decoupled weight decay on every leaf, an f32 master.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Precision", "DocAttention", "Reference", "lr_at",
           "make_weights"]

#: bytes of the f32 temporaries of one attention block
ATTN_BLOCK_BYTES = 2 << 30
#: rows of the head's logits at a time
HEAD_ROWS = 2048
#: elements of an optimizer slice
SLICE = 1 << 26


class Precision:
    """The arithmetic the reference computes in: ``"fp32"`` (TF32 off),
    or the control ``"fp8"``, which rounds to float8 e4m3 (one scale
    per tensor; the rounding is passed straight through in the
    backward) wherever the port's bf16 step holds a value in bf16: the
    operands and the result of every matrix product (weights, norm and
    activation outputs, q, k, v, the attention's probabilities and
    output, the logits) and the residual stream between layers.
    Products accumulate in f32."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        xd = x.detach()
        s = xd.abs().amax().clamp(min=1e-30) / 448.0
        r = (xd / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (r - xd) if x.requires_grad else r

    def mm(self, a, b):
        return self.round(self.round(a) @ self.round(b))


class DocAttention(torch.autograd.Function):
    """Causal attention inside each document of one packed row.  q (T,
    Hq, D), k and v (T, Hkv, D); query head h reads key head h // (Hq /
    Hkv).  ``docs`` are the documents' (start, end) token ranges."""

    @staticmethod
    def _blocks(docs, heads):
        """(document start, query block start, end) of every block: as
        many queries as keep 16 bytes a score under ATTN_BLOCK_BYTES."""
        for s, e in docs:
            per = max(64, ATTN_BLOCK_BYTES // (16 * heads * (e - s)))
            for qs in range(s, e, per):
                yield s, qs, min(qs + per, e)

    @staticmethod
    def _probs(q, k, s, qs, qe, scale, prec):
        """(Hkv, G, n, m) probabilities of queries [qs, qe) over keys
        [s, qe), and their lse."""
        T, Hq, D = q.shape
        Hkv = k.shape[1]
        Q = q[qs:qe].permute(1, 0, 2).reshape(Hkv, Hq // Hkv, qe - qs, D)
        K = k[s:qe].permute(1, 0, 2)[:, None]
        sc = prec.mm(Q, K.transpose(-1, -2)) * scale
        n, m = qe - qs, qe - s
        keep = torch.arange(m, device=q.device)[None, :] <= \
            (qs - s + torch.arange(n, device=q.device))[:, None]
        sc = sc.masked_fill(~keep, float("-inf"))
        lse = torch.logsumexp(sc, dim=-1, keepdim=True)
        return torch.exp(sc - lse), Q, K

    @staticmethod
    def forward(ctx, q, k, v, docs, prec):
        T, Hq, D = q.shape
        Hkv = k.shape[1]
        scale = D ** -0.5
        out = torch.zeros_like(q)
        for s, qs, qe in DocAttention._blocks(docs, Hq):
            p, _, _ = DocAttention._probs(q, k, s, qs, qe, scale, prec)
            V = v[s:qe].permute(1, 0, 2)[:, None]
            o = prec.mm(p, V)                               # (Hkv, G, n, D)
            out[qs:qe] = o.reshape(Hq, qe - qs, D).permute(1, 0, 2)
        ctx.save_for_backward(q, k, v, out)
        ctx.docs, ctx.prec = docs, prec
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        docs, prec = ctx.docs, ctx.prec
        T, Hq, D = q.shape
        Hkv = k.shape[1]
        G = Hq // Hkv
        scale = D ** -0.5
        dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
        delta = (do * out).sum(-1)                          # (T, Hq)
        for s, qs, qe in DocAttention._blocks(docs, Hq):
            n = qe - qs
            p, Q, K = DocAttention._probs(q, k, s, qs, qe, scale, prec)
            V = v[s:qe].permute(1, 0, 2)[:, None]
            dO = do[qs:qe].permute(1, 0, 2).reshape(Hkv, G, n, D)
            dl = delta[qs:qe].permute(1, 0).reshape(Hkv, G, n, 1)
            dv[s:qe] += prec.mm(p.transpose(-1, -2), dO).sum(1) \
                .permute(1, 0, 2)
            ds = p * (prec.mm(dO, V.transpose(-1, -2)) - dl)
            dq[qs:qe] = (prec.mm(ds, K) * scale).reshape(Hq, n, D) \
                .permute(1, 0, 2)
            dk[s:qe] += (prec.mm(ds.transpose(-1, -2), Q) * scale).sum(1) \
                .permute(1, 0, 2)
        return dq, dk, dv, None, None


def lr_at(step: int, train: dict) -> float:
    """The warmup-cosine learning rate of ``step``."""
    warm, total = train["warmup_steps"], train["total_steps"]
    if step < warm:
        return train["lr"] * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    lo = train["min_lr_ratio"]
    return train["lr"] * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi
                                                              * frac)))


def make_weights(module, spec, seed: int, device):
    """``(path, tensor)`` of every leaf, drawn from ``seed`` on
    ``device`` with one generator, one call a leaf, in the
    configuration's dtype (``train.leaf_dtypes`` names the leaves kept in
    another): the weights both sides start from.  A
    generator, so a caller can hold one leaf at a time; the same seed on
    the same device gives the same values."""
    leaf_dtypes = spec.train.get("leaf_dtypes", {})
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for path, shape, init in module.leaf_specs(spec):
        dtype = getattr(torch, leaf_dtypes.get(path, spec.train["dtype"]))
        if init[0] == "ones":
            yield path, torch.ones(shape, dtype=dtype, device=device)
        else:
            x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            yield path, x.mul_(init[1])


def _slices(*ts):
    t = ts[0]
    if t.dim() == 0 or t.numel() <= SLICE:
        yield ts
        return
    per = max(1, SLICE // max(t.numel() // t.shape[0], 1))
    for i in range(0, t.shape[0], per):
        yield tuple(x[i:i + per] for x in ts)


class Reference:
    """The configuration's training steps, from ``weights`` (``{path:
    tensor}``) on ``device``, in ``precision``."""

    def __init__(self, module, spec, weights: dict, device,
                 precision: str = "fp32"):
        self.mod, self.spec, self.dev = module, spec, torch.device(device)
        self.prec = Precision(precision)
        self.train = spec.train
        self.p = {k: v.to(self.dev, torch.float32) for k, v in
                  weights.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.g = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.layer_paths = module.layer_leaves(spec)

    def _attention(self, q, k, v, docs):
        return DocAttention.apply(q, k, v, docs, self.prec)

    def _row(self, doc_lens, tokens, labels, n_valid):
        """Add one row's gradient of (its CE sum / n_valid) into
        ``self.g``; returns its CE sum."""
        mod, spec, dev, p = self.mod, self.spec, self.dev, self.p
        lens = [int(x) for x in doc_lens]
        ends = torch.tensor(lens, device=dev).cumsum(0).tolist()
        docs = list(zip([0] + ends[:-1], ends))
        pos = torch.cat([torch.arange(n, device=dev) for n in lens])
        tok = torch.as_tensor(tokens, device=dev).long()
        lab = torch.as_tensor(labels, device=dev).long()

        def run_layer(i, x, w):
            return self.prec.round(mod.layer(w, x, pos, docs, spec,
                                              self.prec.mm, self._attention))

        saved = [self.prec.round(mod.embed(p, tok))]
        with torch.no_grad():
            for i in range(spec.layers):
                w = {k: p[k][i] for k in self.layer_paths}
                saved.append(run_layer(i, saved[-1], w))
        # the head, a block of rows at a time
        xl = saved.pop().requires_grad_(True)
        gl = {k: p[k].detach().requires_grad_(True)
              for k in mod.head_leaves(spec)}
        h = mod.final_norm(gl, xl, spec)
        hd = h.detach().requires_grad_(True)
        ce_sum = torch.zeros((), device=dev)
        for r in range(0, h.shape[0], HEAD_ROWS):
            lb = self.prec.mm(hd[r:r + HEAD_ROWS], mod.head(gl, spec))
            lr_ = lab[r:r + HEAD_ROWS]
            mask = (lr_ >= 0).float()
            lse = torch.logsumexp(lb, dim=-1)
            gold = lb.gather(-1, lr_.clamp(min=0)[:, None])[:, 0]
            ce = ((lse - gold) * mask).sum()
            (ce / n_valid).backward()
            ce_sum += ce.detach()
        torch.autograd.backward(h, hd.grad)
        for k in gl:
            self.g[k] += gl[k].grad
        dx = xl.grad
        del xl, h, hd, gl
        for i in reversed(range(spec.layers)):
            xin = saved.pop().requires_grad_(True)
            w = {k: p[k][i].detach().requires_grad_(True)
                 for k in self.layer_paths}
            out = run_layer(i, xin, w)
            grads = torch.autograd.grad(out, [xin, *w.values()], dx)
            dx = grads[0]
            for k, gw in zip(w, grads[1:]):
                self.g[k][i] += gw
            del out, grads, xin
        self.g[mod.EMBED].index_add_(0, tok, dx)
        return ce_sum

    def loss_and_grads(self, rows, drop_half: bool = False) -> float:
        """The loss of a batch of rows (each ``(doc_lens, tokens,
        labels)``) into ``self.g``: the masked CE mean over every
        row's labels.  ``drop_half`` (a planted fault) leaves the
        second half of every row's labels out of the loss and its
        mean."""
        for g in self.g.values():
            g.zero_()
        if drop_half:
            rows = [(lens, tok, _half(lab)) for lens, tok, lab in rows]
        n_valid = sum(int((torch.as_tensor(lab) >= 0).sum())
                      for _, _, lab in rows)
        total = sum(self._row(lens, tok, lab, max(n_valid, 1))
                    for lens, tok, lab in rows)
        return float(total) / max(n_valid, 1)

    @torch.no_grad()
    def apply(self, step: int) -> None:
        """Clip ``self.g`` by the global norm, then one AdamW step."""
        t = self.train
        norm = math.sqrt(sum(float((g * g).sum()) for g in self.g.values()))
        scale = min(1.0, t["grad_clip"] / max(norm, 1e-9))
        for g in self.g.values():
            g.mul_(scale)
        self.count += 1
        b1, b2 = t["betas"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        lr, eps, wd = lr_at(step, t), t["eps"], t["weight_decay"]
        for k in self.p:
            for p, g, mu, nu in _slices(self.p[k], self.g[k], self.mu[k],
                                        self.nu[k]):
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(eps))
                upd.add_(p, alpha=wd)
                p.sub_(upd.mul_(lr))

    def grad_norms(self) -> dict:
        """Each leaf's gradient norm as the optimizer got it (after
        clipping): valid right after :meth:`apply`."""
        return {k: float(torch.linalg.vector_norm(g))
                for k, g in self.g.items()}


def _half(labels):
    lab = torch.as_tensor(labels).clone()
    lab[lab.shape[0] // 2:] = -1
    return lab
