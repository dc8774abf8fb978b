"""Optimization methods: ``OptimMethod``, ``SGD``, ``Adam``, ``Adagrad``,
``Adadelta``, ``Adamax``, ``RMSprop``, ``LBFGS`` and ``EMA``.

Counterpart of ``bigdl_tpu/optim/method.py`` (reference
``optim/OptimMethod.scala:28``, ``optim/SGD.scala:38``, ``Adam.scala``,
``Adagrad.scala``, ``Adadelta.scala``, ``Adamax.scala``, ``RMSprop.scala``).
The reference's pure ``update(grads, params, state, lr) -> (params,
state)`` becomes an in-place update of the parameter tensors that returns
the new method state; the arithmetic is the reference's, term by term, as
``torch._foreach_*`` operations over all tensors at once.  A method's state
holds one list per slot (``velocity``, ``m``, ``v``, ...), in the order of
``model.parameters()``; ``utils/convert.py`` maps those lists to and from
the reference's param-shaped trees.  Host-side hyper-parameter logic (the
schedule, the driver's counters) stays outside the update and feeds it a
scalar ``lr`` each iteration.

``LBFGS`` keeps its history per parameter (lists of [m, numel] tensors),
where the reference ravels the whole tree into one vector; its dot
products sum over the parameters.  ``utils/convert.py`` ravels and
unravels that history in the reference's leaf order.  ``EMA`` wraps any
method and keeps a shadow copy of the weights.

``update_fused`` runs the same update over one flat tensor per dtype
(``optim/fused.py``), bit-identical to ``update``; ``supports_fused`` is
False for ``LBFGS`` alone.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .schedules import Default

__all__ = ["OptimMethod", "SGD", "Adam", "Adagrad", "Adadelta", "Adamax",
           "RMSprop", "LBFGS", "EMA"]


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def _apply(params, steps):
    """w -= step, each step cast to its parameter's dtype (the reference's
    ``w - step.astype(w.dtype)``)."""
    torch._foreach_sub_(params, [s.to(p.dtype) for s, p in zip(steps, params)])


def _host_tree(tree):
    """A method state with numpy leaves for its tensors (dicts and lists
    kept, other leaves copied)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_tree(v) for v in tree]
    return copy.deepcopy(tree)


def _tensor_tree(tree):
    """The inverse of :func:`_host_tree`: numpy arrays become tensors;
    scalars (Adam's int32 ``t``) stay as they are."""
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree)
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensor_tree(v) for v in tree]
    return copy.deepcopy(tree)


def _count(t) -> np.int32:
    """An int32 step count (the reference keeps ``t`` as an int32 scalar)."""
    return np.int32(t)


class OptimMethod:
    """Base optimizer (reference: optim/OptimMethod.scala:28)."""

    #: the update is elementwise per parameter, so it may run over fused
    #: buffers (``optim/fused.py``) and on ZeRO's 1/N slices
    supports_fused = True

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = learning_rate
        # host-side mirror of the driver state (the reference's state Table)
        self.hyper = {"evalCounter": 0, "epoch": 1}

    def init_state(self, params):
        return {}

    def update(self, grads, params, state, lr):
        """Update ``params`` (a list of tensors) in place from ``grads``;
        returns the new method state."""
        raise NotImplementedError

    def update_fused(self, grads, params, state, lr):
        """:meth:`update` over one flat tensor per dtype
        (``optim/fused.py``), bit-identical to it; the per-leaf update
        where the method does not support fusing."""
        if not self.supports_fused:
            return self.update(grads, params, state, lr)
        from .fused import fused_update
        return fused_update(self, grads, params, state, lr)

    def get_learning_rate(self, driver_state=None) -> float:
        return self.learning_rate

    def bind_dot(self, dot=None):
        """The dot product of two per-parameter lists that an update over
        every parameter uses (``LBFGS``'s): a mesh strategy's, which sums
        the whole parameters' product from this rank's shards, or None
        for this process's own.  An elementwise method takes none."""

    def optimize(self, feval, x):
        """One host-side step, the reference's ``optimize(feval, x)``
        (``OptimMethod.scala:38``): ``feval(x) -> (loss, grads)`` over a
        list of tensors ``x``, which is updated in place and returned with
        ``[loss]``.  The state stays on the instance, so repeated calls
        continue the trajectory."""
        loss, grads = feval(x)
        if not hasattr(self, "_opt_state"):
            self._opt_state = self.init_state(x)
        lr = self.get_learning_rate(self.hyper)
        self._opt_state = self.update(grads, x, self._opt_state, lr)
        self.hyper["evalCounter"] = self.hyper.get("evalCounter", 0) + 1
        return x, [float(loss)]

    def get_hyper_parameter(self):
        return {"learningRate": self.get_learning_rate()}

    def load_hyper(self, d):
        self.hyper.update(d)

    def state_dict(self):
        """The hyper-parameters and driver mirror as plain Python, and the
        host-side ``optimize`` trajectory (numpy leaves) where there is
        one: what the reference pickles into ``optimMethod.<n>``."""
        d = {"hyper": dict(self.hyper), "learning_rate": self.learning_rate}
        if hasattr(self, "_opt_state"):
            d["opt_state"] = _host_tree(self._opt_state)
        if hasattr(self, "_ls_state"):
            d["ls_state"] = copy.deepcopy(self._ls_state)
        return d

    def load_state_dict(self, d):
        """Restore exactly the snapshot: live ``optimize`` state that the
        snapshot lacks is dropped."""
        self.hyper = dict(d["hyper"])
        self.learning_rate = d["learning_rate"]
        for attr, key, conv in (("_opt_state", "opt_state", _tensor_tree),
                                ("_ls_state", "ls_state", copy.deepcopy)):
            if key in d:
                setattr(self, attr, conv(d[key]))
            elif hasattr(self, attr):
                delattr(self, attr)


class SGD(OptimMethod):
    """SGD with weight decay, momentum, dampening and nesterov, Torch's
    semantics: g += wd·w; v = mu·v + (1 − damp)·g; g = g + mu·v (nesterov)
    or v; w −= clr·g, with clr from the schedule (Default:
    lr / (1 + neval·lrd)).  The velocity starts at zero."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: float = None, nesterov: bool = False,
                 learning_rate_schedule=None):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov requires momentum > 0 and dampening = 0 (SGD.scala)")
        self.schedule = learning_rate_schedule or Default()

    def init_state(self, params):
        if self.momentum > 0:
            return {"velocity": _zeros(params)}
        return {}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        wd, mu, damp = self.weight_decay, self.momentum, self.dampening
        grads = list(grads)
        if wd > 0:
            grads = torch._foreach_add(grads, torch._foreach_mul(params, wd))
        if mu > 0:
            vel = torch._foreach_add(
                torch._foreach_mul(state["velocity"], mu),
                torch._foreach_mul(grads, 1 - damp))
            grads = (torch._foreach_add(grads, torch._foreach_mul(vel, mu))
                     if self.nesterov else vel)
            state = {"velocity": vel}
        _apply(params, torch._foreach_mul(grads, float(lr)))
        return state

    def get_learning_rate(self, driver_state=None):
        return self.schedule.get_lr(self, driver_state or self.hyper)


class _DecayedLR:
    """lr / (1 + neval · lrd), read from the driver's ``evalCounter``."""

    def get_learning_rate(self, driver_state=None):
        neval = (driver_state or self.hyper).get("evalCounter", 0)
        return self.learning_rate / (1 + neval * self.learning_rate_decay)


class Adam(_DecayedLR, OptimMethod):
    """Adam (reference: optim/Adam.scala; Torch semantics with bias
    correction): m = b1·m + (1 − b1)·g; v = b2·v + (1 − b2)·g²;
    w −= lr·sqrt(1 − b2^t) / (1 − b1^t) · m / (sqrt(v) + eps).  The step
    count ``t`` is an int32 and the bias corrections are float32, as in
    the reference."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params), "t": _count(0)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = _count(state["t"] + 1)
        m = torch._foreach_add(torch._foreach_mul(state["m"], b1),
                               torch._foreach_mul(grads, 1 - b1))
        v = torch._foreach_add(
            torch._foreach_mul(state["v"], b2),
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        f32 = np.float32
        tf = f32(t)
        bc1 = f32(1) - np.power(f32(b1), tf)
        bc2 = f32(1) - np.power(f32(b2), tf)
        step = f32(lr) * np.sqrt(bc2) / bc1
        denom = torch._foreach_add(torch._foreach_sqrt(v), eps)
        _apply(params, torch._foreach_div(
            torch._foreach_mul(m, float(step)), denom))
        return {"m": m, "v": v, "t": t}


class Adagrad(_DecayedLR, OptimMethod):
    """Adagrad (reference: optim/Adagrad.scala): g += wd·w; a += g²;
    w −= lr·g / (sqrt(a) + 1e-10)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params):
        return {"accum": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        grads = list(grads)
        if self.weight_decay > 0:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(params, self.weight_decay))
        accum = torch._foreach_add(state["accum"],
                                   torch._foreach_mul(grads, grads))
        denom = torch._foreach_add(torch._foreach_sqrt(accum), 1e-10)
        _apply(params, torch._foreach_div(
            torch._foreach_mul(grads, float(lr)), denom))
        return {"accum": accum}


class Adadelta(OptimMethod):
    """Adadelta (reference: optim/Adadelta.scala): ag = rho·ag + (1 − rho)·g²;
    dx = g·sqrt(adx + eps) / sqrt(ag + eps); adx = rho·adx + (1 − rho)·dx²;
    w −= lr·dx, with lr a fixed 1.0."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__(1.0)
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return {"accum_g": _zeros(params), "accum_dx": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        rho, eps = self.rho, self.epsilon
        ag = torch._foreach_add(
            torch._foreach_mul(state["accum_g"], rho),
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - rho))
        dx = torch._foreach_div(
            torch._foreach_mul(grads, torch._foreach_sqrt(
                torch._foreach_add(state["accum_dx"], eps))),
            torch._foreach_sqrt(torch._foreach_add(ag, eps)))
        adx = torch._foreach_add(
            torch._foreach_mul(state["accum_dx"], rho),
            torch._foreach_mul(torch._foreach_mul(dx, dx), 1 - rho))
        _apply(params, torch._foreach_mul(dx, float(lr)))
        return {"accum_g": ag, "accum_dx": adx}


class Adamax(OptimMethod):
    """Adamax (reference: optim/Adamax.scala): m = b1·m + (1 − b1)·g;
    u = max(b2·u, |g| + eps); w −= lr / (1 − b1^t) · m / u, the bias
    correction float32 from an int32 ``t``."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params), "t": _count(0)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        b1, b2 = self.beta1, self.beta2
        t = _count(state["t"] + 1)
        m = torch._foreach_add(torch._foreach_mul(state["m"], b1),
                               torch._foreach_mul(grads, 1 - b1))
        u = torch._foreach_maximum(
            torch._foreach_mul(state["u"], b2),
            torch._foreach_add(torch._foreach_abs(grads), self.epsilon))
        f32 = np.float32
        bc = f32(1) - np.power(f32(b1), f32(t))
        scale = f32(lr) / bc
        _apply(params, torch._foreach_div(
            torch._foreach_mul(m, float(scale)), u))
        return {"m": m, "u": u, "t": t}


class RMSprop(_DecayedLR, OptimMethod):
    """RMSprop (reference: optim/RMSprop.scala): r = rho·r + (1 − rho)·g²;
    w −= lr·g / (sqrt(r) + eps)."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0, decay_rate: float = 0.99,
                 epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.learning_rate_decay = learning_rate_decay
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return {"rms": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        rms = torch._foreach_add(
            torch._foreach_mul(state["rms"], self.rho),
            torch._foreach_mul(torch._foreach_mul(grads, grads),
                               1 - self.rho))
        denom = torch._foreach_add(torch._foreach_sqrt(rms), self.epsilon)
        _apply(params, torch._foreach_div(
            torch._foreach_mul(grads, float(lr)), denom))
        return {"rms": rms}


def _dot(a, b):
    """Σ a·b over every tensor pair, a float32 scalar tensor (the
    reference's ``jnp.dot`` of the raveled trees)."""
    return torch.stack([torch.sum(x * y) for x, y in zip(a, b)]).sum()


class LBFGS(OptimMethod):
    """L-BFGS with a fixed-size history and a fixed step inside the
    training step (reference: optim/LBFGS.scala; the reference's
    ``method.py:312-460``), and with a strong-Wolfe line search in the
    host-side :meth:`optimize` (LineSearch.scala ``lswolfe``).

    The state keeps, per parameter, the last ``history_size`` steps ``s``
    and gradient changes ``y`` as [m, numel] rows (oldest first), and the
    previous weights and gradient; ``rho`` [m] and the int32 ``count`` are
    shared.  A history entry is pushed only when yᵀs > 1e-10 after the
    first update; an empty slot has rho = 0 and drops out of the two-loop
    recursion.

    Under a mesh strategy (``parallel/sharding.py`` ``LayoutSharding``,
    ``TensorParallel``) the parameters and the rows are this rank's
    shards, and the ``Optimizer`` binds the strategy's ``dot``
    (``OptimMethod.bind_dot``): every dot product of the two-loop recursion is
    then summed over the ranks that hold each leaf's other shards, each
    element counted once, as the reference's raveled tree is one
    vector."""

    #: the history's dot products run over every parameter
    supports_fused = False

    def __init__(self, learning_rate: float = 1.0, max_iter: int = 1,
                 history_size: int = 10, tolerance_grad: float = 1e-7):
        super().__init__(learning_rate)
        self.m = history_size
        self.max_iter = max_iter
        self.tolerance_grad = tolerance_grad
        self._dot = _dot

    def bind_dot(self, dot=None):
        self._dot = dot or _dot

    def init_state(self, params):
        rows = [p.detach().reshape(-1) for p in params]
        dev = params[0].device if params else None
        return {"s": [torch.zeros((self.m, r.numel()), dtype=r.dtype,
                                  device=r.device) for r in rows],
                "y": [torch.zeros((self.m, r.numel()), dtype=r.dtype,
                                  device=r.device) for r in rows],
                "rho": torch.zeros((self.m,), device=dev),
                "count": _count(0),
                "prev_flat": [r.clone() for r in rows],
                "prev_grad": [torch.zeros_like(r) for r in rows]}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        flat = [p.detach().reshape(-1) for p in params]
        gflat = [g.reshape(-1).to(p.dtype) for g, p in zip(grads, params)]
        count = state["count"]
        s_new = torch._foreach_sub(flat, state["prev_flat"])
        y_new = torch._foreach_sub(gflat, state["prev_grad"])
        ys = self._dot(y_new, s_new)
        valid = (ys > 1e-10) & bool(count > 0)

        def push(bufs, rows):
            return [torch.where(valid, torch.cat([b[1:], r[None]]), b)
                    for b, r in zip(bufs, rows)]
        s, y = push(state["s"], s_new), push(state["y"], y_new)
        rho = torch.where(valid, torch.cat(
            [state["rho"][1:], (1.0 / torch.clamp(ys, min=1e-10))[None]]),
            state["rho"])
        # the two-loop recursion over the fixed-size history
        q = list(gflat)
        alphas = []
        for i in range(self.m - 1, -1, -1):
            a = rho[i] * self._dot([si[i] for si in s], q)
            q = [qj - a * yj[i] for qj, yj in zip(q, y)]
            alphas.append((i, a))
        yy = self._dot(y_new, y_new)
        gamma = torch.where(valid, ys / torch.clamp(yy, min=1e-10),
                            torch.ones_like(ys))
        r = [gamma * qj for qj in q]
        for i, a in reversed(alphas):
            b = rho[i] * self._dot([yj[i] for yj in y], r)
            r = [rj + sj[i] * (a - b) for rj, sj in zip(r, s)]
        prev = [f.clone() for f in flat]
        _apply(params, [(float(lr) * rj).reshape(p.shape)
                        for rj, p in zip(r, params)])
        return {"s": s, "y": y, "rho": rho, "count": _count(count + 1),
                "prev_flat": prev, "prev_grad": [g.clone() for g in gflat]}

    # -- host-side optimize() with a strong-Wolfe line search -----------

    def optimize(self, feval, x):
        """Up to ``max_iter`` iterations of the two-loop direction and a
        strong-Wolfe line search, each probe one ``feval`` call, in
        float64 on the host (the reference's ``optimize``).  ``x`` (a list
        of tensors) is updated in place and returned with the loss at
        every ``feval``."""
        sizes = [t.numel() for t in x]

        def unravel(flat):
            parts = np.split(flat, np.cumsum(sizes)[:-1])
            return [torch.as_tensor(p.reshape(t.shape), dtype=t.dtype)
                    for p, t in zip(parts, x)]

        def fg(flat):
            loss, grads = feval(unravel(flat))
            self.hyper["evalCounter"] = self.hyper.get("evalCounter", 0) + 1
            g = np.concatenate([np.asarray(gr.detach().cpu(), np.float64)
                                .reshape(-1) for gr in grads])
            return float(loss), g

        if not hasattr(self, "_ls_state"):
            self._ls_state = {"s": [], "y": [], "first": True}
        st = self._ls_state
        flat = np.concatenate([np.asarray(t.detach().cpu(), np.float64)
                               .reshape(-1) for t in x])
        f, g = fg(flat)
        losses = [f]
        for _ in range(self.max_iter):
            if np.abs(g).max() <= self.tolerance_grad:
                break
            d = -self._host_two_loop(st["s"], st["y"], g)
            gtd = float(g @ d)
            if gtd > -1e-12:  # not a descent direction: reset the history
                st["s"], st["y"] = [], []
                d, gtd = -g, -float(g @ g)
            # the first step ever is scaled as the reference's lbfgs does
            t0 = (min(1.0, 1.0 / np.abs(g).sum()) * self.learning_rate
                  if st["first"] else self.learning_rate)
            st["first"] = False
            t, f_new, g_new = _strong_wolfe(
                lambda tt: fg(flat + tt * d), d, f, gtd, t0)
            if not (f_new <= f):  # NaN-safe: no decrease found, stop here
                losses.append(f)
                break
            losses.append(f_new)
            s_new = t * d
            y_new = g_new - g
            if float(y_new @ s_new) > 1e-10:
                st["s"].append(s_new)
                st["y"].append(y_new)
                if len(st["s"]) > self.m:
                    st["s"].pop(0)
                    st["y"].pop(0)
            flat, f, g = flat + s_new, f_new, g_new
            if np.abs(s_new).max() <= 1e-9:
                break
        with torch.no_grad():
            for t, v in zip(x, unravel(flat)):
                t.copy_(v)
        return x, losses

    @staticmethod
    def _host_two_loop(ss, ys, g):
        q = g.copy()
        alphas = []
        for s, y in zip(reversed(ss), reversed(ys)):
            rho = 1.0 / float(y @ s)
            a = rho * float(s @ q)
            q -= a * y
            alphas.append((s, y, rho, a))
        if ss:
            s_l, y_l = ss[-1], ys[-1]
            q *= float(y_l @ s_l) / float(y_l @ y_l)
        for s, y, rho, a in reversed(alphas):
            b = rho * float(y @ q)
            q += s * (a - b)
        return q


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """The minimizer of the cubic through (a, fa, dfa), (b, fb, dfb); the
    midpoint where the geometry degenerates."""
    d1 = dfa + dfb - 3 * (fa - fb) / (a - b)
    sq = d1 * d1 - dfa * dfb
    if sq < 0:
        return (a + b) / 2.0
    d2 = sq ** 0.5 * (1 if b >= a else -1)
    t = b - (b - a) * ((dfb + d2 - d1) / (dfb - dfa + 2 * d2 + 1e-300))
    lo, hi = min(a, b), max(a, b)
    if not (lo < t < hi):
        return (a + b) / 2.0
    return t


def _strong_wolfe(phi, d, f0, df0, t0, c1=1e-4, c2=0.9, max_ls=25):
    """Strong-Wolfe line search, bracket then zoom by cubic interpolation
    (the reference's ``_strong_wolfe``).  ``phi(t) -> (f, g)`` evaluates
    along the ray ``d``.  Returns (t, f, g) at an acceptable point, or the
    best point seen."""
    t_prev, f_prev, df_prev = 0.0, f0, df0
    g_prev = None
    t = t0
    bracket = None
    f, g = phi(t)
    df = float(g @ d)
    for it in range(max_ls):
        if f > f0 + c1 * t * df0 or (it > 0 and f >= f_prev):
            bracket = (t_prev, f_prev, df_prev, g_prev, t, f, df, g)
            break
        if abs(df) <= -c2 * df0:
            return t, f, g
        if df >= 0:
            bracket = (t, f, df, g, t_prev, f_prev, df_prev, g_prev)
            break
        t_prev, f_prev, df_prev, g_prev = t, f, df, g
        t = min(t * 2.0, 1e10)
        f, g = phi(t)
        df = float(g @ d)
    if bracket is None:
        return t, f, g
    lo_t, lo_f, lo_df, lo_g, hi_t, hi_f, hi_df, _ = bracket
    for _ in range(max_ls):
        t = _cubic_min(lo_t, lo_f, lo_df, hi_t, hi_f, hi_df)
        f, g = phi(t)
        df = float(g @ d)
        if f > f0 + c1 * t * df0 or f >= lo_f:
            hi_t, hi_f, hi_df = t, f, df
        else:
            if abs(df) <= -c2 * df0:
                return t, f, g
            if df * (hi_t - lo_t) >= 0:
                hi_t, hi_f, hi_df = lo_t, lo_f, lo_df
            lo_t, lo_f, lo_df, lo_g = t, f, df, g
        if abs(hi_t - lo_t) < 1e-9:
            break
    if lo_g is not None and lo_t > 0:
        return lo_t, lo_f, lo_g
    return t, f, g


class EMA(OptimMethod):
    """An exponential moving average of the weights beside any inner
    method (the reference's ``method.py:523-579``): after each inner
    update, shadow = d·shadow + (1 − d)·params.  ``ema_params(state)``
    gives the shadow; after ``Optimizer.optimize()`` the model keeps the
    live weights and :meth:`apply_to` copies the shadow (and the trained
    buffers, which are not averaged) into another model."""

    def __init__(self, inner: OptimMethod, decay: float = 0.999):
        super().__init__(learning_rate=inner.learning_rate)
        if not 0.0 < decay < 1.0:
            raise ValueError(f"EMA decay {decay}")
        self.inner = inner
        self.decay = decay
        # the inner's driver mirror to start with; the Optimizer rebinds
        # ours, so the learning rate always passes ours down
        self.hyper = inner.hyper

    @property
    def supports_fused(self):
        return self.inner.supports_fused

    def bind_dot(self, dot=None):
        self.inner.bind_dot(dot)

    def init_state(self, params):
        # real copies, never aliases of the parameters
        return {"inner": self.inner.init_state(params),
                "shadow": [p.detach().clone() for p in params]}

    @torch.no_grad()
    def update(self, grads, params, state, lr):
        inner = self.inner.update(grads, params, state["inner"], lr)
        d = self.decay
        shadow = torch._foreach_add(torch._foreach_mul(state["shadow"], d),
                                    torch._foreach_mul(params, 1 - d))
        return {"inner": inner, "shadow": shadow}

    def get_learning_rate(self, driver_state=None) -> float:
        return self.inner.get_learning_rate(
            self.hyper if driver_state is None else driver_state)

    def ema_params(self, opt_state):
        return opt_state["shadow"]

    @staticmethod
    def apply_to(model, optimizer):
        """Copy the shadow weights and the trained buffers (BatchNorm's
        running statistics) of a finished Optimizer run into the built
        ``model``; returns it."""
        shadow = optimizer.optim_method.ema_params(optimizer.final_opt_state)
        params = list(model.parameters())
        buffers = list(model.buffers())
        trained = list(optimizer.model.buffers())
        if len(params) != len(shadow) or len(buffers) != len(trained):
            raise ValueError("EMA.apply_to: the model does not match the "
                             "trained one")
        with torch.no_grad():
            for p, s in zip(params, shadow):
                p.copy_(s)
            for b, t in zip(buffers, trained):
                b.copy_(t)
        return model
