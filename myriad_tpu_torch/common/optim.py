"""Learning-rate schedules and the optimizer (counterpart of
``myriad_tpu/common/optim.py``).

The schedules are ``step -> lr`` functions, as in the JAX package.
``AdamW`` is ``make_optimizer``'s optax chain, computed in the same order on
the trainable tensors: optional ``clip_by_global_norm`` first, then Adam
(b1, b2, eps 1e-8, bias correction at the optimizer's own count), weight
decay added to the update of tensors with ndim >= 2 only, and the update
scaled by ``-schedule(count)``; ``mu_dtype`` stores the first moment in
another dtype.  ``accum_grad_iters`` > 1 is ``optax.MultiSteps``: each
call folds the gradient into a running mean, and every k-th call updates
with that mean and clears it.  Over a tensor-parallel ``mesh`` the global
norm of ``clip_by_global_norm`` is the whole model's: the squares of the
tensors that are shards (``sharded``) are summed over the model group, the
replicated ones counted once.

``optax_tree`` and ``load_optax_tree`` carry the state to and from the optax
tree that ``make_optimizer``'s chain holds, in the form an Orbax checkpoint
restores it (dicts and lists): ``clip_by_global_norm``'s empty state as None
when clipping, then adamw's ``[{count, mu, nu}, {inner_state: None},
{count}]``, inside ``{mini_step, gradient_step, inner_opt_state, acc_grads,
skip_state}`` when ``accum_grad_iters`` > 1.  The moments travel as trees in
the JAX layout, by name: the caller gives the conversions.  Loading matches
every leaf by its key and raises on a missing, extra or mis-shaped one; it
never assigns by leaf order (the JAX runner's ``_resume`` does, and puts the
``MultiSteps`` state's leaves in the wrong places: deviation D3).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def linear_warmup_cosine_lr(*, init_lr: float, min_lr: float, max_epoch: int,
                            iters_per_epoch: int, warmup_steps: int = 0,
                            warmup_start_lr: float = -1.0, **_unused) -> Schedule:
    """Linear warmup to ``init_lr`` over ``warmup_steps``, then
    (init_lr - min_lr) * 0.5 * (1 + cos(pi t / T)) + min_lr, T =
    max_epoch * iters_per_epoch."""
    warmup_start = warmup_start_lr if warmup_start_lr >= 0 else init_lr
    total = max(max_epoch * iters_per_epoch, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return min(init_lr,
                       warmup_start + (init_lr - warmup_start) * step / max(warmup_steps, 1))
        return (init_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * step / total)) + min_lr

    return schedule


def linear_warmup_step_lr(*, init_lr: float, min_lr: float, iters_per_epoch: int,
                          decay_rate: float = 1.0, warmup_steps: int = 0,
                          warmup_start_lr: float = -1.0, **_unused) -> Schedule:
    """Warmup within epoch 0, then max(min_lr, init_lr * decay_rate ** epoch)."""
    warmup_start = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step: int) -> float:
        epoch = math.floor(step / max(iters_per_epoch, 1))
        if epoch < 1:
            in_epoch = step - epoch * iters_per_epoch
            return min(init_lr, warmup_start
                       + (init_lr - warmup_start) * in_epoch / max(warmup_steps, 1))
        return max(min_lr, init_lr * decay_rate ** epoch)

    return schedule


SCHEDULES = {"linear_warmup_cosine_lr": linear_warmup_cosine_lr,
             "linear_warmup_step_lr": linear_warmup_step_lr}


def build_schedule(name: str, **kwargs) -> Schedule:
    try:
        return SCHEDULES[name](**kwargs)
    except KeyError:
        raise KeyError(f"Unknown lr_sched '{name}'. Registered: "
                       f"[{', '.join(sorted(SCHEDULES))}]") from None


_DTYPES = {None: None, "float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


class AdamW:
    """optax's ``clip_by_global_norm`` -> ``adamw`` (-> ``MultiSteps``) over
    named tensors.  ``step()`` reads each tensor's ``.grad`` and updates it in
    place; the gradients are left as they are."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]], schedule: Schedule, *,
                 weight_decay: float = 0.05, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = None,
                 accum_grad_iters: int = 1, mu_dtype=None, mesh=None,
                 sharded: Optional[Sequence[bool]] = None):
        if mu_dtype not in _DTYPES:
            raise ValueError(f"optimizer_mu_dtype {mu_dtype!r}: one of {sorted(map(str, _DTYPES))}")
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule = schedule
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, beta1, beta2, eps
        self.max_grad_norm = None if max_grad_norm is None else float(max_grad_norm)
        self.k = max(int(accum_grad_iters), 1)
        self.mu_dtype = _DTYPES[mu_dtype]
        # a tensor-parallel mesh, and which tensors are its shards
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        self.sharded = list(sharded) if sharded is not None else [False] * len(self.params)
        self.count = 0  # optimizer updates made (optax's inner count)
        self.mini_step = 0  # gradients folded into ``acc`` since the last update
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Fold in the gradients; update when k of them are in.  Returns
        whether the parameters changed."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g.to(a.dtype) - a) / (n + 1))
            self.mini_step = (n + 1) % self.k
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        self._update([g.float() if g.dtype != p.dtype else g
                      for g, p in zip(grads, self.params)])
        return True

    def _update(self, grads: List[torch.Tensor]) -> None:
        if self.max_grad_norm is not None:
            g_norm = self._global_norm(grads)
            if not bool(g_norm < self.max_grad_norm):
                grads = [(g / g_norm.to(g.dtype)) * self.max_grad_norm for g in grads]
        count_inc = self.count + 1
        f32 = torch.float32
        bc1 = 1.0 - float(torch.tensor(self.b1, dtype=f32) ** count_inc)
        bc2 = 1.0 - float(torch.tensor(self.b2, dtype=f32) ** count_inc)
        step_size = -float(torch.tensor(self.schedule(self.count), dtype=f32))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = g * (1.0 - self.b1) + self.mu[i].to(g.dtype) * self.b1
            nu = (g * g) * (1.0 - self.b2) + self.nu[i] * self.b2
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if p.ndim >= 2:
                upd = upd + self.weight_decay * p
            p.add_((upd * step_size).to(p.dtype))
            self.mu[i] = mu.to(self.mu[i].dtype)
            self.nu[i] = nu
        self.count = count_inc

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The L2 norm over every gradient; over a mesh the whole model's, the
        shards' squares summed over the model group (the same bits on every
        rank of a group)."""
        if self.mesh is None:
            return torch.sqrt(sum(torch.sum(g * g) for g in grads))
        squares = [torch.sum(g * g) for g in grads]
        whole = torch.zeros((), dtype=squares[0].dtype, device=squares[0].device)
        parts = torch.zeros((1,), dtype=squares[0].dtype, device=squares[0].device)
        for sq, shard in zip(squares, self.sharded):
            if shard:
                parts[0] += sq
            else:
                whole = whole + sq
        self.mesh.model_sum_([parts])
        return torch.sqrt(whole + parts[0])

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu)),
                "acc": dict(zip(self.names, self.acc)) if self.acc is not None else None}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            bufs = getattr(self, key)
            if bufs is None or state.get(key) is None:
                continue
            for i, name in enumerate(self.names):
                bufs[i].copy_(state[key][name].to(bufs[i].device))

    # -- the optax tree ----------------------------------------------------------
    def optax_tree(self, to_tree: Callable[[Dict[str, torch.Tensor]], Dict]) -> Any:
        """The state as ``make_optimizer``'s optax state, restored from an
        Orbax checkpoint; ``to_tree`` turns {name: tensor} into the JAX-layout
        tree of the trainables."""
        count = torch.tensor(self.count, dtype=torch.int32)
        adam = {"count": count, "mu": to_tree(dict(zip(self.names, self.mu))),
                "nu": to_tree(dict(zip(self.names, self.nu)))}
        inner = [[adam, {"inner_state": None}, {"count": count.clone()}]]
        if self.max_grad_norm is not None:
            inner.insert(0, None)
        if self.acc is None:
            return inner
        return {"mini_step": torch.tensor(self.mini_step, dtype=torch.int32),
                "gradient_step": count.clone(), "inner_opt_state": inner,
                "acc_grads": to_tree(dict(zip(self.names, self.acc))), "skip_state": ()}

    @torch.no_grad()
    def load_optax_tree(self, state: Any,
                        from_tree: Callable[[Mapping], Dict[str, torch.Tensor]]) -> None:
        """Take the state from an optax tree of this optimizer's chain, each
        leaf by its key; ``from_tree`` turns a JAX-layout tree into {name:
        tensor in the port's layout}.  Raises ``ValueError`` where the tree is
        not this chain's or a moment is missing, extra or mis-shaped."""
        def field(node, key, where):
            if not isinstance(node, Mapping) or key not in node:
                raise ValueError(f"optimizer state: no {where}{key}")
            return node[key]

        inner = state
        if self.acc is not None:
            inner = field(state, "inner_opt_state", "")
        want = 2 if self.max_grad_norm is not None else 1
        if not isinstance(inner, (list, tuple)) or len(inner) != want:
            raise ValueError(f"optimizer state: inner_opt_state is not the chain of "
                             f"{'clip_by_global_norm, ' if want == 2 else ''}adamw")
        adamw = inner[-1]
        if not isinstance(adamw, (list, tuple)) or len(adamw) != 3:
            raise ValueError("optimizer state: adamw's state is not (adam, masked, schedule)")
        adam = adamw[0]
        moments = {key: self._named(from_tree(field(adam, key, "adam.")), key)
                   for key in ("mu", "nu")}
        if self.acc is not None:
            moments["acc"] = self._named(from_tree(field(state, "acc_grads", "")), "acc_grads")
            mini_step = int(field(state, "mini_step", ""))
            if not 0 <= mini_step < self.k:
                raise ValueError(f"optimizer state: mini_step {mini_step} outside 0..{self.k - 1}")
            self.mini_step = mini_step
        self.count = int(field(adam, "count", "adam."))
        for key, named in moments.items():
            bufs = getattr(self, key)
            for i, name in enumerate(self.names):
                bufs[i].copy_(named[name].to(bufs[i].device))

    def _named(self, named: Dict[str, torch.Tensor], what: str) -> Dict[str, torch.Tensor]:
        missing = [n for n in self.names if n not in named]
        extra = sorted(set(named) - set(self.names))
        if missing or extra:
            raise ValueError(f"optimizer state {what}: missing {missing[:3]} "
                             f"({len(missing)}), extra {extra[:3]} ({len(extra)})")
        for name, p in zip(self.names, self.params):
            if tuple(named[name].shape) != tuple(p.shape):
                raise ValueError(f"optimizer state {what}: {name} has shape "
                                 f"{tuple(named[name].shape)}, the parameter {tuple(p.shape)}")
        return named
