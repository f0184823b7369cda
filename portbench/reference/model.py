"""Plain float32 forward of a Llama-family decoder (Llama, Mistral,
Qwen2), from the published equations, for judging what the port served.

Imports torch alone: nothing of the port, nothing of JAX. It reads the
weights the benchmark drew (the port's layout: layer weights stacked on
axis 0, projections as (in, out)) and computes in float32 with TF32 off,
one layer at a time, each layer's weights widened as it runs, so that it
fits on the card beside the bf16 weights.

    h_0 = embed[tokens]
    per layer:  x = rmsnorm(h) * w_attn_norm
                q, k, v = x Wq (+ bq), x Wk (+ bk), x Wv (+ bv)   (Qwen2: bias)
                q, k = rope(q), rope(k)    (rotate-half, theta ** (-2i/d))
                h = h + softmax(q k^T / sqrt(d) + causal) v Wo
                x = rmsnorm(h) * w_mlp_norm
                h = h + (silu(x Wgate) * (x Wup)) Wdown
    logits = rmsnorm(h) * w_final_norm  Wlm   (tied: embed^T)

Query head j reads kv head j // (nq / nkv) (grouped-query attention).
No sliding window: neither configuration has one.

``weight`` maps each stored matrix to the float32 matrix the forward
uses: the identity upcast for the reference; the control passes a
lower-precision rounding of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

QUERY_BLOCK = 1024


def f32(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, d) rotated at positions pos (T,)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d // 2, dtype=torch.float32,
                                  device=x.device) * 2.0 / d)
    ang = pos.float()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def attention(q, k, v) -> torch.Tensor:
    """Causal attention of q (T, nq, d) over k, v (T, nkv, d), in query
    blocks so the scores fit."""
    T, nq, d = q.shape
    group = nq // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # (nq, T, d)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(T, device=q.device)
    for s in range(0, T, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, T)
        qb = q[s:e].transpose(0, 1)                       # (nq, b, d)
        scores = qb @ k[:, :e].transpose(1, 2) * d**-0.5  # (nq, b, e)
        mask = keys[None, :e] > torch.arange(s, e, device=q.device)[:, None]
        scores.masked_fill_(mask[None], float("-inf"))
        out[s:e] = (scores.softmax(-1) @ v[:, :e]).transpose(0, 1)
    return out


def logits(hf: dict, params: dict, tokens: torch.Tensor,
           rows: torch.Tensor, weight=f32) -> torch.Tensor:
    """(len(rows), vocab) float32 logits at positions `rows` of the
    sequence `tokens` (positions 0..T-1)."""
    no_tf32()
    eps = hf["rms_norm_eps"]
    theta = hf.get("rope_theta", 10000.0)
    nq = hf["num_attention_heads"]
    nkv = hf.get("num_key_value_heads", nq)
    d = hf.get("head_dim") or hf["hidden_size"] // nq
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    lay = params["layers"]
    h = params["embed"][tokens].float()
    for l in range(hf["num_hidden_layers"]):
        x = rms_norm(h, lay["attn_norm"][l], eps)
        q, k, v = (x @ weight(lay[n][l]) for n in ("wq", "wk", "wv"))
        if "bq" in lay:
            q = q + lay["bq"][l].float()
            k = k + lay["bk"][l].float()
            v = v + lay["bv"][l].float()
        q = rope(q.view(T, nq, d), pos, theta)
        k = rope(k.view(T, nkv, d), pos, theta)
        a = attention(q, k, v.view(T, nkv, d)).reshape(T, nq * d)
        h = h + a @ weight(lay["wo"][l])
        x = rms_norm(h, lay["mlp_norm"][l], eps)
        g = F.silu(x @ weight(lay["w_gate"][l])) * (x @ weight(lay["w_up"][l]))
        h = h + g @ weight(lay["w_down"][l])
    x = rms_norm(h[rows], params["final_norm"], eps)
    head = params.get("lm_head")
    return x @ (weight(head) if head is not None
                else weight(params["embed"]).t())
