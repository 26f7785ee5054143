"""A plain dense decoder LM (Phi-3 family, arXiv:2404.14219) as the two
levels of the LM bilevel task, in float32 plain PyTorch, one node at a
time.

Per layer (pre-norm residual), with RMSNorm(v) = v / sqrt(mean(v^2) + eps)
times its scale:

    h  = RMSNorm1(x);  q, k, v = h Wq, h Wk, h Wv  (heads of head_dim)
    q, k rotated (RoPE, theta; the two halves of each head rotated)
    x += softmax(q k^T / sqrt(head_dim), causal) v Wo
    h  = RMSNorm2(x);  x += (silu(h Wg) * (h Wi)) Wo

then the final RMSNorm and the untied head; the loss is the mean
cross-entropy of every position's next token.  The bilevel split: x is
the backbone (the embedding and the layers), y the head (the final norm
and the head matrix).

    f_i(x, y) = CE on node i's validation tokens
    g_i(x, y) = CE on node i's training tokens + ridge * |y|^2

A tree is a flat dict of node-stacked leaves: ``embed`` (m, V, D),
``final_norm`` (m, D), ``lm_head`` (m, D, V) and, for each layer stacked
on the axis after the nodes, ``blocks.0.norm1``, ``blocks.0.attn.wq`` …
``blocks.0.mlp.wo``.  The y-gradients reuse the backbone's output, which
depends on x alone, within a round (`begin_round`).
"""

from __future__ import annotations

import torch

from perfbench.reference.c2dfb import Precision

HEAD = ("final_norm", "lm_head")


class Model:
    def __init__(self, cfg: dict, precision: Precision):
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.hd = self.D // self.H
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.L = cfg["num_hidden_layers"]
        self.prec = precision
        if cfg["num_key_value_heads"] != self.H:
            raise ValueError("the plain model has as many key and value heads as query heads")

    def mm(self, a, b):
        return self.prec.operand(a) @ self.prec.operand(b)

    def norm(self, v, scale):
        return v * torch.rsqrt(v.pow(2).mean(dim=-1, keepdim=True) + self.eps) * scale

    def rope(self, t):
        S = t.shape[1]
        freqs = 1.0 / (self.theta ** (torch.arange(0, self.hd, 2, dtype=torch.float32, device=t.device) / self.hd))
        ang = torch.arange(S, dtype=torch.float32, device=t.device)[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        a, b = t[..., : self.hd // 2], t[..., self.hd // 2:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    def backbone(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """One node's hidden states before the final norm; p holds that
        node's float32 leaves, tokens (B, S)."""
        B, S = tokens.shape
        x = p["embed"][tokens]
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        for r in range(self.L):
            w = {k[len("blocks.0."):]: v[r] for k, v in p.items() if k.startswith("blocks.0.")}
            h = self.norm(x, w["norm1"])
            q = self.rope(self.mm(h, w["attn.wq"]).reshape(B, S, self.H, self.hd))
            k = self.rope(self.mm(h, w["attn.wk"]).reshape(B, S, self.H, self.hd))
            v = self.mm(h, w["attn.wv"]).reshape(B, S, self.H, self.hd)
            scores = self.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / self.hd ** 0.5
            probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
            out = self.mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, self.D)
            x = x + self.mm(out, w["attn.wo"])
            h = self.norm(x, w["norm2"])
            gate = self.mm(h, w["mlp.wg"])
            x = x + self.mm(gate * torch.sigmoid(gate) * self.mm(h, w["mlp.wi"]), w["mlp.wo"])
        return x

    def ce(self, hidden, final_norm, lm_head, labels):
        logits = self.mm(self.norm(hidden, final_norm), lm_head)
        logp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
        return -logp.gather(1, labels.reshape(-1, 1)).mean()


class Oracles:
    """The four gradients C²DFB asks for, node by node, computed in float32
    and stored at the state's precision."""

    def __init__(self, cfg: dict, val: dict, train: dict, ridge: float, precision: Precision):
        self.prec = precision
        self.model = Model(cfg, precision)
        self.val, self.train, self.ridge = val, train, ridge
        self.hidden = None

    @staticmethod
    def _node(tree: dict, i: int, grad: bool = False) -> dict:
        return {k: v[i].to(torch.float32).detach().requires_grad_(grad) for k, v in tree.items()}

    def begin_round(self, x: dict):
        """The backbone's output on every node's validation and training
        tokens: it depends on x alone."""
        m = next(iter(x.values())).shape[0]
        with torch.no_grad():
            self.hidden = [{s: self.model.backbone(self._node(x, i), d["tokens"][i])
                            for s, d in (("val", self.val), ("train", self.train))} for i in range(m)]

    def _head_loss(self, i: int, yi: dict, f_weight: float, g_weight: float):
        mdl, loss = self.model, 0.0
        if f_weight:
            loss = loss + f_weight * mdl.ce(self.hidden[i]["val"], yi["final_norm"], yi["lm_head"],
                                            self.val["labels"][i])
        if g_weight:
            reg = sum(torch.sum(v * v) for v in yi.values())
            loss = loss + g_weight * (mdl.ce(self.hidden[i]["train"], yi["final_norm"], yi["lm_head"],
                                             self.train["labels"][i]) + self.ridge * reg)
        return loss

    def _y_grad(self, y: dict, f_weight: float, g_weight: float) -> dict:
        m = next(iter(y.values())).shape[0]
        out = {k: [] for k in y}
        for i in range(m):
            with torch.enable_grad():
                yi = self._node(y, i, grad=True)
                grads = torch.autograd.grad(self._head_loss(i, yi, f_weight, g_weight), list(yi.values()))
            for k, g in zip(yi, grads):
                out[k].append(self.prec.store(g))
        return {k: torch.stack(v) for k, v in out.items()}

    def _x_grad(self, x: dict, y: dict, data: dict) -> dict:
        m = next(iter(x.values())).shape[0]
        out = {k: [] for k in x}
        for i in range(m):
            with torch.enable_grad():
                xi, yi = self._node(x, i, grad=True), self._node(y, i)
                hidden = self.model.backbone(xi, data["tokens"][i])
                loss = self.model.ce(hidden, yi["final_norm"], yi["lm_head"], data["labels"][i])
                grads = torch.autograd.grad(loss, list(xi.values()))
            for k, g in zip(xi, grads):
                out[k].append(self.prec.store(g))
            del hidden, loss, grads
        return {k: torch.stack(v) for k, v in out.items()}

    def grad_y_h(self, x, y, lam):
        return self._y_grad(y, 1.0, lam)

    def grad_y_g(self, x, z):
        return self._y_grad(z, 0.0, 1.0)

    def grad_x_f(self, x, y):
        return self._x_grad(x, y, self.val)

    def grad_x_g(self, x, y):
        return self._x_grad(x, y, self.train)
