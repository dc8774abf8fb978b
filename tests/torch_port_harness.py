"""Shared checks of the port's layers and criteria against the JAX package,
for the ``tests/test_torch_port_layers*.py`` files.

A pair is built from the JAX module's params, carried over with
``bigdl_torch.utils.convert.load_reference_tree``; inputs (a numpy array
or a nested list of them, the reference's Table) and cotangents come from
numpy's RandomState.  Floating inputs take gradients, integer ones
(indices, labels, masks) do not.

Tolerances:
- float32: outputs, input gradients and parameter gradients within 1e-5
  of the compared tensor's largest magnitude (at least 1).  Both sides
  compute in float32 and differ in summation order.
- bfloat16 compute (floating inputs cast to bf16 on both sides, the
  compute dtype bf16 in both policies): the output dtype must equal
  JAX's, and values agree within 0.05 absolute + 0.02 relative, as
  ``tests/test_torch_port_train_modules.py`` holds bf16.  Both round to
  bf16 (2^-8 relative) at different places.
"""

import contextlib

import numpy as np
import torch

import jax
import jax.numpy as jnp
from bigdl_tpu.common import DTypePolicy as JPolicy
from bigdl_tpu.common import get_policy as jget_policy
from bigdl_tpu.common import set_policy as jset_policy

from bigdl_torch.common import DTypePolicy as TPolicy
from bigdl_torch.common import get_policy as tget_policy
from bigdl_torch.common import set_policy as tset_policy
from bigdl_torch.utils.convert import load_reference_tree

F32 = 1e-5
BF16_TOL = dict(atol=5e-2, rtol=2e-2)


def x(shape, seed=0, positive=False, scale=1.0):
    v = np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32) * scale
    return np.abs(v) + 0.5 if positive else v


def labels(shape, n, seed=0):
    return np.random.RandomState(seed).randint(0, n, shape).astype(np.int32)


def signs(shape, seed=0):
    return np.where(np.random.RandomState(seed).rand(*shape) > 0.5, 1.0,
                    -1.0).astype(np.float32)


def flat(t):
    if isinstance(t, (list, tuple)):
        return [v for e in t for v in flat(e)]
    return [t]


def unflat(like, leaves):
    it = iter(leaves)

    def rec(t):
        if isinstance(t, (list, tuple)):
            return [rec(e) for e in t]
        return next(it)
    return rec(like)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def close(port, ref, tol=F32, what=""):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _grad_tree(module):
    from bigdl_torch.nn import Container
    if isinstance(module, Container):
        return [_grad_tree(m) for m in module.layers]
    out = {}
    for n in module.param_names:
        p = getattr(module, n)
        out[n] = torch.zeros_like(p) if p.grad is None else p.grad
    return out


def build_pair(jmod, tmod, seed=0):
    jmod.build(jax.random.key(seed))
    tmod.build("cpu")
    load_reference_tree(tmod, jax.tree.map(np.asarray, jmod.params),
                        jax.tree.map(np.asarray, jmod.state))
    return jmod, tmod


def module_parity(jmod, tmod, inputs, seed=0, jax_fn=None):
    """Forward, input gradients and parameter gradients of ``tmod`` (eval
    mode) against ``jmod`` on ``inputs`` with a random cotangent.
    ``jax_fn(params, inputs)``, where given, stands in for the JAX
    module's apply (the reference's eager semantics of a layer whose
    apply takes another form under a trace)."""
    build_pair(jmod, tmod, seed)
    leaves = flat(inputs)
    fidx = [i for i, a in enumerate(leaves) if _is_float(a)]
    jleaves = [jnp.asarray(a) for a in leaves]

    def jf(params, fl):
        ls = list(jleaves)
        for i, v in zip(fidx, fl):
            ls[i] = v
        xs = unflat(inputs, ls)
        if jax_fn is not None:
            return jax_fn(params, xs)
        y, _ = jmod.apply(params, jmod.state, xs, training=False)
        return y

    fl = [jleaves[i] for i in fidx]
    shapes = jax.eval_shape(jf, jmod.params, fl)
    rs = np.random.RandomState(seed + 101)
    cts = [rs.standard_normal(y.shape).astype(np.float32)
           for y in flat(shapes)]

    @jax.jit
    def forward_and_vjp(params, fl, ct):
        y, vjp = jax.vjp(jf, params, fl)
        return y, vjp(ct)
    # one compiled program per case: quicker than the op-by-op dispatch
    jy, (jgp, jgx) = forward_and_vjp(
        jmod.params, fl, unflat(shapes, [jnp.asarray(c).astype(y.dtype)
                                         for c, y in zip(cts, flat(shapes))]))

    tl = [torch.from_numpy(np.array(a)) for a in leaves]
    for i in fidx:
        tl[i].requires_grad_()
    tmod.eval()
    ty = tmod(unflat(inputs, tl))
    tys = flat(ty)
    assert len(tys) == len(flat(jy))
    for k, (a, b) in enumerate(zip(tys, flat(jy))):
        close(a, b, what=f"output {k}")
    outs = [(a, torch.from_numpy(c)) for a, c in zip(tys, cts)
            if a.requires_grad]
    if outs:
        torch.autograd.backward([a for a, _ in outs], [c for _, c in outs])
    for i, g in zip(fidx, jgx):
        got = tl[i].grad if tl[i].grad is not None else torch.zeros_like(
            tl[i])
        close(got, g, what=f"input grad {i}")
    pg, rg = jax.tree.leaves(_grad_tree(tmod)), jax.tree.leaves(jgp)
    assert len(pg) == len(rg)
    for k, (a, b) in enumerate(zip(pg, rg)):
        close(a, b, what=f"param grad {k}")
    return tmod


@contextlib.contextmanager
def bf16_policy():
    jold, told = jget_policy(), tget_policy()
    jset_policy(JPolicy(compute_dtype=jnp.bfloat16))
    tset_policy(TPolicy(compute_dtype=torch.bfloat16))
    try:
        yield
    finally:
        jset_policy(jold)
        tset_policy(told)


def module_bf16(jmod, tmod, inputs, seed=0, jax_fn=None):
    """The forward with floating inputs in bf16 under a bf16 compute
    policy: the output dtype equals JAX's, the values agree within
    ``BF16_TOL``."""
    with bf16_policy():
        build_pair(jmod, tmod, seed)
        leaves = flat(inputs)
        jl = [jnp.asarray(a).astype(jnp.bfloat16) if _is_float(a)
              else jnp.asarray(a) for a in leaves]
        tl = [torch.from_numpy(np.array(a)).to(torch.bfloat16)
              if _is_float(a) else torch.from_numpy(np.array(a))
              for a in leaves]
        if jax_fn is not None:
            jy = jax_fn(jmod.params, unflat(inputs, jl))
        else:
            jy, _ = jmod.apply(jmod.params, jmod.state, unflat(inputs, jl),
                               training=False)
        with torch.no_grad():
            ty = tmod.eval()(unflat(inputs, tl))
    for a, b in zip(flat(ty), flat(jy)):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), (
            a.dtype, b.dtype)
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   **BF16_TOL)


def _to_torch(t):
    if isinstance(t, (list, tuple)):
        return [_to_torch(e) for e in t]
    return torch.from_numpy(np.array(t))


def _to_jax(t):
    if isinstance(t, (list, tuple)):
        return [_to_jax(e) for e in t]
    return jnp.asarray(t)


def criterion_parity(jcrit, tcrit, output, target):
    """The loss and its gradient with respect to every floating output
    against the JAX criterion; for a tensor output also the facade's
    ``backward``."""
    outs = flat(output)
    jl, jg = jax.value_and_grad(
        lambda o: jcrit.loss(unflat(output, o), _to_jax(target)))(
            [jnp.asarray(o) for o in outs])
    to = [torch.from_numpy(np.array(o)).requires_grad_() for o in outs]
    tloss = tcrit(unflat(output, to), _to_torch(target))
    tloss.backward()
    close(tloss, jl, what="loss")
    for k, (a, b) in enumerate(zip(to, jg)):
        close(a.grad, b, what=f"grad {k}")
    if not isinstance(output, (list, tuple)):
        close(tcrit.backward(torch.from_numpy(np.array(output)),
                             _to_torch(target)), jg[0], what="backward")


def criterion_bf16(jcrit, tcrit, output, target):
    """The loss on bf16 outputs: the dtype equals JAX's, the value agrees
    within ``BF16_TOL``."""
    with bf16_policy():
        jo = [jnp.asarray(o).astype(jnp.bfloat16) for o in flat(output)]
        to = [torch.from_numpy(np.array(o)).to(torch.bfloat16)
              for o in flat(output)]
        jl = jcrit.loss(unflat(output, jo), _to_jax(target))
        with torch.no_grad():
            tl = tcrit(unflat(output, to), _to_torch(target))
    assert str(tl.dtype).replace("torch.", "") == str(jl.dtype), (
        tl.dtype, jl.dtype)
    np.testing.assert_allclose(_np(tl), np.asarray(jl, np.float32),
                               **BF16_TOL)
