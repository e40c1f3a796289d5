"""LLaMA (Vicuna-7B) decoder with a preallocated KV cache (counterpart of
``myriad_tpu/models/llama.py``), for serving and training.

The frozen projections are int8 weight-only (``QuantDense``: kernel B1 at
decode), int4 group-wise weight-only (``Quant4Dense``: kernel B5 at decode)
or plain Dense (k/o/gate/up/down, and the q/v bases; ``lm_head`` stays
float); q_proj/v_proj carry the LoRA pair when
``use_lora`` (no LoRA dropout: the JAX package trains with
``deterministic=True``).  Attention goes through ``ops.attention.mha``:
prefill chunks attend causally by absolute position (kernel B3), decode
steps attend over the first ``kv_len`` cache positions with the additive
-1e9 mask (kernel B2).  A forward without a cache (training) runs the whole
sequence from position 0 under a causal and key-padding mask, with the
attention in plain torch (``plain_mha``, the arithmetic of the JAX
package's ``_xla_mha``, whose no-cache path is XLA too); ``remat`` wraps
each layer in ``torch.utils.checkpoint``.

The cache is preallocated and written in place at its ``index``: unlike
the JAX package's functional cache, a forward with a cache mutates it.
This is the port's one in-place deviation.  ``index`` is an int (every row
at one frontier) or a (B,) int32 tensor of per-row frontiers (speculative
decoding's ragged acceptance); every write goes through kernel B4
(``ops/kv_write.py``), which clamps a start to [0, T - t] as the JAX
package's cache writes do.

Built with a ``mesh`` (``parallel.mesh.Mesh`` of ``n_model`` > 1; or
``LlamaForCausalLM.sharded(mesh)`` from a whole model), the model is this
rank's shard, Megatron-style as ``parallel.partition.LLAMA_RULES`` cuts the
state: the rank holds ``num_heads / n`` heads (and ``kv_heads / n``); q, k,
v, gate and up are column-parallel (the rank's output columns, their int8
scales; under LoRA the rank's ``lora_b`` columns, ``lora_a`` whole); o and
down row-parallel (the rank's input rows, the whole scale; an int4 shard's
rows may start or end inside a group: down's 11008 rows over 4 ranks are
21.5 groups of 128 a rank), each partial
product summed over the model group in fp32 and rounded once;
``embed_tokens`` is split over hidden and the looked-up rows are gathered;
``lm_head`` is split over the vocabulary and the logits are gathered whole
on every rank, so every rank takes each decision (argmax, stop rules) from
the same bits.  Its ``config`` is the rank's (``shard_config``: its heads,
``head_dim`` explicit, its MLP width), which sizes its KV cache;
``full_config`` is the model's.  Norms, the residual stream and the cache's
frontiers are whole on every rank.

A sharded model trains too (``forward_full`` under autograd, through
``Mesh``'s autograd collectives): the normed input of attention and of the
MLP goes through ``copy_to_model``, so that one all-reduce of its gradient
a block covers q, k and v (or gate and up) and the LoRA branch beside them;
o and down sum their outputs with ``reduce_from_model`` (no collective
backward); the embedding and the vocabulary-split logits gather with
``gather_from_model`` (the rank's slice of the gradient backward), the
head's input going through ``copy_to_model`` first.  Every rank of a group
then computes the same logits and loss; a shard's gradient is its slice of
the whole model's, and ``lora_a``'s (whole on every rank, inside the
column-parallel region) is a part that the runner sums over the group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from myriad_tpu_torch.models.layers import (Dense, Policy, maybe_quant_dense, merge_heads,
                                            new_param)
from myriad_tpu_torch.ops import kv_write
from myriad_tpu_torch.ops.attention import causal_mask, mha, plain_mha
# quantize_kv lives beside kernel B4; it is also reachable here, where the
# JAX package defines it
from myriad_tpu_torch.ops.kv_write import quantize_kv  # noqa: F401

Cache = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    use_lora: bool = False
    lora_rank: int = 8
    lora_alpha: int = 16
    weight_dtype: str = "bf16"   # "bf16", "int8" or "int4" (weight-only)
    kv_cache_dtype: str = "bf16"  # "bf16" or "int8" (fp16 per-position scales)
    remat: bool = False  # recompute each layer in the backward (no-cache forward)

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dims_per_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        base = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                           num_layers=2, num_heads=4)
        return dataclasses.replace(base, **overrides)


def shard_config(cfg: LlamaConfig, n: int) -> LlamaConfig:
    """One rank's config on a model axis of ``n``: its heads and KV heads,
    ``head_dim`` explicit, its share of the MLP width; hidden and vocabulary
    whole.  Raises where ``n`` does not divide them."""
    widths = {"num_heads": cfg.num_heads, "kv_heads": cfg.kv_heads,
              "intermediate_size": cfg.intermediate_size, "hidden_size": cfg.hidden_size}
    bad = {k: v for k, v in widths.items() if v % n}
    if bad:
        raise ValueError(f"a model axis of {n} does not divide {bad}")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                               num_kv_heads=cfg.kv_heads // n, head_dim=cfg.dims_per_head,
                               intermediate_size=cfg.intermediate_size // n)


class RMSNorm(nn.Module):
    is_norm = True

    def __init__(self, dim: int, eps: float, *, policy: Policy, device):
        super().__init__()
        self.eps = eps
        self.weight = new_param((dim,), policy.param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(B, T) positions -> cos, sin (B, T, head_dim) fp32, HF rotate_half layout."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    freqs = positions.float()[..., None] * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); cos/sin (B, T, D)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :].to(x.dtype) + rotated * sin[:, :, None, :].to(x.dtype)


class LoraDense(nn.Module):
    """Frozen projection ``base`` + optional low-rank update (alpha/r) x A B.
    In a column-parallel shard (``d_out`` the rank's) ``lora_b`` holds the
    rank's output columns and ``lora_a`` is whole."""

    def __init__(self, cfg: LlamaConfig, d_in: int, d_out: int, *, policy: Policy, device):
        super().__init__()
        self.base = maybe_quant_dense(cfg.weight_dtype, d_in, d_out, policy=policy,
                                      device=device)
        self.lora_a = self.lora_b = None
        if cfg.use_lora:
            self.lora_a = Dense(d_in, cfg.lora_rank, use_bias=False, policy=policy,
                                device=device)
            self.lora_b = Dense(cfg.lora_rank, d_out, use_bias=False, policy=policy,
                                device=device)
            self.lora_scale = cfg.lora_alpha / cfg.lora_rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        if self.lora_a is not None:
            y = y + self.lora_b(self.lora_a(x)) * self.lora_scale
        return y


def set_frontier(cache: List[Cache], index) -> None:
    """Set every layer's write frontier (an int or a (B,) int32 tensor)."""
    for layer_cache in cache:
        layer_cache["index"] = index


def serving_cache_dtype(config: LlamaConfig, compute_dtype):
    return "int8" if config.kv_cache_dtype == "int8" else compute_dtype


def init_cache(config: LlamaConfig, batch: int, max_len: int, dtype, device) -> List[Cache]:
    """Per-layer preallocated (B, Hk, Tmax, D) buffers.  ``dtype="int8"``: int8
    payloads plus per-position scales stored fp16 (cast to fp32 at use)."""
    shape = (batch, config.kv_heads, max_len, config.dims_per_head)
    caches = []
    for _ in range(config.num_layers):
        if dtype in ("int8", torch.int8):
            sshape = shape[:-1] + (1,)
            caches.append({
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float16, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float16, device=device),
                "index": 0,
            })
        else:
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device),
                           "index": 0})
    return caches


class LlamaAttention(nn.Module):
    """``cfg`` is the rank's under a ``mesh`` (its heads); o_proj is then
    row-parallel over the mesh's model group."""

    def __init__(self, cfg: LlamaConfig, *, policy: Policy, device, mesh=None):
        super().__init__()
        self.cfg = cfg
        h, hk, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        kw = dict(policy=policy, device=device)
        self.q_proj = LoraDense(cfg, cfg.hidden_size, h * d, **kw)
        self.k_proj = maybe_quant_dense(cfg.weight_dtype, cfg.hidden_size, hk * d, **kw)
        self.v_proj = LoraDense(cfg, cfg.hidden_size, hk * d, **kw)
        self.o_proj = maybe_quant_dense(cfg.weight_dtype, h * d, cfg.hidden_size, mesh=mesh,
                                        **kw)

    def forward(self, hidden: torch.Tensor, positions: torch.Tensor, cache: Optional[Cache],
                mask: Optional[torch.Tensor], kv_len: int) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = hidden.shape
        h, hk, d = cfg.num_heads, cfg.kv_heads, cfg.dims_per_head
        q = self.q_proj(hidden).reshape(b, t, h, d)
        k = self.k_proj(hidden).reshape(b, t, hk, d)
        v = self.v_proj(hidden).reshape(b, t, hk, d)
        cos, sin = rope_cos_sin(positions, d, cfg.rope_theta)
        q = apply_rope(q, cos, sin).transpose(1, 2)
        k = apply_rope(k, cos, sin).transpose(1, 2)
        v = v.transpose(1, 2)
        if cache is None:  # the whole sequence at once: the additive mask, no kernel
            if hk != h:
                k, v = k.repeat_interleave(h // hk, 1), v.repeat_interleave(h // hk, 1)
            out = plain_mha(q, k.to(q.dtype), v.to(q.dtype), mask=mask, scale=d ** -0.5)
            return self.o_proj(merge_heads(out))

        # the write frontier (int or per-row tensor); LlamaModel advances it
        idx = cache["index"]
        k_sc = v_sc = None
        if "k_scale" in cache:
            # int8 KV: per-(batch, head, position) quant at write, one B4
            # launch for K and V; the scales fold into the attention
            # logits/probs, the cache is never dequantized as a tensor
            kv_write.kv_quantize_write(cache["k"], cache["v"], cache["k_scale"],
                                       cache["v_scale"], k, v, idx)
            k_sc, v_sc = cache["k_scale"], cache["v_scale"]
        else:
            kv_write.kv_cache_write(cache["k"], k.to(cache["k"].dtype), idx)
            kv_write.kv_cache_write(cache["v"], v.to(cache["v"].dtype), idx)
        k_all, v_all = cache["k"], cache["v"]

        if hk != h:
            rep = h // hk
            k_all, v_all = k_all.repeat_interleave(rep, 1), v_all.repeat_interleave(rep, 1)
            if k_sc is not None:
                k_sc, v_sc = k_sc.repeat_interleave(rep, 1), v_sc.repeat_interleave(rep, 1)
        if k_sc is None:
            k_all, v_all = k_all.to(q.dtype), v_all.to(q.dtype)

        if t == 1:
            out = mha(q, k_all, v_all, mask=mask, scale=d ** -0.5, k_scale=k_sc,
                      v_scale=v_sc, kv_len=kv_len)
        else:
            out = mha(q, k_all, v_all, scale=d ** -0.5, k_scale=k_sc, v_scale=v_sc,
                      positions=positions)
        return self.o_proj(merge_heads(out))


class LlamaMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, policy: Policy, device, mesh=None):
        super().__init__()
        d, f, kw = cfg.hidden_size, cfg.intermediate_size, dict(policy=policy, device=device)
        self.gate_proj = maybe_quant_dense(cfg.weight_dtype, d, f, **kw)
        self.up_proj = maybe_quant_dense(cfg.weight_dtype, d, f, **kw)
        self.down_proj = maybe_quant_dense(cfg.weight_dtype, f, d, mesh=mesh, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(torch.nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, policy: Policy, device, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, policy=policy,
                                       device=device)
        self.self_attn = LlamaAttention(cfg, policy=policy, device=device, mesh=mesh)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                                policy=policy, device=device)
        self.mlp = LlamaMlp(cfg, policy=policy, device=device, mesh=mesh)

    def _column_input(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh is None else self.mesh.copy_to_model(x)

    def forward(self, hidden, positions, cache, mask, kv_len):
        hidden = hidden + self.self_attn(self._column_input(self.input_layernorm(hidden)),
                                         positions, cache, mask, kv_len)
        return hidden + self.mlp(self._column_input(self.post_attention_layernorm(hidden)))


class Embed(nn.Module):
    """Embedding table: gather, then cast to the compute dtype.  With
    ``mesh``, the rank's ``dim / n`` columns of every row; the looked-up
    rows are gathered whole over the model group."""

    def __init__(self, num: int, dim: int, *, policy: Policy, device, mesh=None):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.mesh = mesh
        n = mesh.n_model if mesh is not None else 1
        self.embedding = new_param((num, dim // n), policy.param_dtype, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.embedding[ids]
        if self.mesh is not None:
            rows = self.mesh.gather_from_model(rows)
        return rows.to(self.dtype)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, policy: Policy, device, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = policy.compute_dtype
        self.mesh = mesh
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, policy=policy, device=device,
                                  mesh=mesh)
        self.layers = nn.ModuleList(LlamaLayer(cfg, policy=policy, device=device, mesh=mesh)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, policy=policy, device=device)

    def forward_full(self, inputs_embeds: torch.Tensor,
                     attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The no-cache forward (training): positions 0..T-1, each query sees
        the keys at or before it whose ``attention_mask`` (B, T) entry is 1."""
        b, t, _ = inputs_embeds.shape
        positions = torch.arange(t, dtype=torch.int32, device=inputs_embeds.device)
        positions = positions[None].expand(b, t)
        allowed = positions[:, None, None, :] <= positions[:, None, :, None]
        if attention_mask is not None:
            allowed = allowed & attention_mask[:, None, None, :].bool()
        mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)
        hidden = inputs_embeds.to(self.dtype)
        if self.mesh is not None and torch.is_grad_enabled() and not hidden.requires_grad:
            # every rank of a group runs the same collectives backward: the
            # stream needs a gradient on each (the image tokens that the
            # group's first rank computed require one there alone)
            hidden = hidden.detach().requires_grad_()
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                hidden = torch.utils.checkpoint.checkpoint(layer, hidden, positions, None, mask,
                                                           t, use_reentrant=False)
            else:
                hidden = layer(hidden, positions, None, mask, t)
        return self.norm(hidden)

    def forward(self, inputs_embeds: torch.Tensor, cache: List[Cache],
                kv_limit: Optional[int] = None) -> torch.Tensor:
        """Run over ``inputs_embeds`` (B, T, D) at the cache's write frontier,
        writing the new K/V in place and advancing every layer's frontier by
        T.  The frontier is an int or a (B,) int32 tensor of per-row
        frontiers; positions are then ``index[:, None] + arange(T)``.
        ``kv_limit``: a decode step attends only over cache positions <
        kv_limit (exact while the frontier stays below it: staged decode)."""
        b, t, _ = inputs_embeds.shape
        start = cache[0]["index"]
        kv_len = cache[0]["k"].shape[2]
        if kv_limit is not None:
            kv_len = min(kv_len, int(kv_limit))
        arange = torch.arange(t, dtype=torch.int32, device=inputs_embeds.device)
        if torch.is_tensor(start):  # per-row frontiers
            positions = start[:, None] + arange[None, :]
        else:
            positions = (start + arange)[None].expand(b, t)
        # a decode step takes the additive mask over absolute positions, as the
        # JAX package does; a prefill chunk's kernel applies causality itself.
        # Either way a slot at or past a row's frontier is never seen before
        # it is written, so stale entries (a speculative rollback, an earlier
        # turn's decode scratch) stay out.
        mask = causal_mask(positions, kv_len) if t == 1 else None
        hidden = inputs_embeds.to(self.dtype)
        for layer, layer_cache in zip(self.layers, cache):
            hidden = layer(hidden, positions, layer_cache, mask, kv_len)
        set_frontier(cache, start + t)
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """The LLaMA with its head; ``mesh`` (n_model > 1) builds this rank's
    shard (the module docstring), which a state dict cut by
    ``parallel.partition.shard_state_dict(..., LLAMA_RULES)`` fills."""

    def __init__(self, cfg: LlamaConfig, *, policy: Policy, device, mesh=None):
        super().__init__()
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        self.policy = policy
        self.full_config = cfg
        n = self.mesh.n_model if self.mesh is not None else 1
        self.config = shard_config(cfg, n) if self.mesh is not None else cfg
        self.model = LlamaModel(self.config, policy=policy, device=device, mesh=self.mesh)
        # the vocabulary is split when the axis divides it (else whole: the
        # rules' replication fallback)
        self.vocab_split = self.mesh is not None and cfg.vocab_size % n == 0
        self.lm_head = new_param((cfg.hidden_size, cfg.vocab_size // (n if self.vocab_split
                                                                      else 1)),
                                 policy.param_dtype, device)

    @torch.no_grad()
    def sharded(self, mesh) -> "LlamaForCausalLM":
        """This rank's shard on ``mesh`` of this whole model (on its device):
        its state cut by ``shard_state_dict`` with ``LLAMA_RULES``, each
        piece taken in its own dtype (a trainable raised to fp32 stays
        fp32); ``split_dims`` records the dim each state entry is cut along
        (None: whole)."""
        from myriad_tpu_torch.parallel.partition import (LLAMA_RULES, shard_state_dict,
                                                         split_dims)

        if self.mesh is not None:
            raise ValueError("the model is already a shard")
        out = LlamaForCausalLM(self.full_config, policy=self.policy, device=self.lm_head.device,
                               mesh=mesh)
        state = self.state_dict()
        out.load_state_dict(shard_state_dict(state, mesh, LLAMA_RULES), strict=True, assign=True)
        out.split_dims = split_dims(state, mesh.n_model, LLAMA_RULES)
        return out

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        # fp32 sum and output at the sampling point, as JAX's
        # preferred_element_type=float32 (the greedy-parity island)
        if self.vocab_split:
            hidden = self.mesh.copy_to_model(hidden)
        out = torch.matmul(hidden.float(), self.lm_head.to(hidden.dtype).float())
        return self.mesh.gather_from_model(out) if self.vocab_split else out

    def prefill(self, inputs_embeds: torch.Tensor, cache: List[Cache],
                last_index=None) -> torch.Tensor:
        """Logits (B, 1, V) of one position only; fills the cache in place.

        The last position by default; ``last_index`` (an int, or a (B,) int
        tensor for per-row columns) selects another, clamped into the chunk
        as the JAX package's dynamic slice clamps it."""
        hidden = self.model(inputs_embeds, cache)
        t = hidden.shape[1]
        if last_index is None:
            hidden = hidden[:, -1:]
        elif torch.is_tensor(last_index) and last_index.dim() == 1:
            li = last_index.to(device=hidden.device, dtype=torch.int64).clamp(0, t - 1)
            hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), li][:, None]
        else:
            li = min(max(int(last_index), 0), t - 1)
            hidden = hidden[:, li:li + 1]
        return self.logits(hidden)

    def forward(self, inputs_embeds: torch.Tensor, cache: Optional[List[Cache]],
                kv_limit: Optional[int] = None,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """fp32 logits (B, T, V).  With a cache: at its frontier, written in
        place.  Without one (training): the whole sequence under the causal
        and ``attention_mask`` key-padding mask."""
        if cache is None:
            return self.logits(self.model.forward_full(inputs_embeds, attention_mask))
        return self.logits(self.model(inputs_embeds, cache, kv_limit))


def lm_nll(logits: torch.Tensor, targets: torch.Tensor,
           ignore_index: int = -100) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parts of the shifted LM loss (the JAX package's
    ``lm_cross_entropy``) in fp32 with ``ignore_index`` masked: logits (B, T,
    V), targets (B, T); (the nll summed over the unmasked positions, their
    count as int64).  The loss is the sum over the count (at least 1); ranks
    that hold parts of one batch sum both over the ranks before dividing
    (the global token mean)."""
    logits = logits[:, :-1].float()
    labels = targets[:, 1:]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()
