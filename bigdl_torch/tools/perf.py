"""Training-step throughput on synthetic data.

Counterpart of ``bigdl_tpu/tools/perf.py`` (reference
``models/utils/DistriOptimizerPerf.scala:91-95`` and
``LocalOptimizerPerf.scala``): one model of the zoo, built and paired with
its criterion by ``models/run._build_model`` as real training pairs them,
takes ``SGD(0.01, momentum=0.9)`` steps of the ``Optimizer`` on one
seeded synthetic batch held on the device (no data loading), and the
records a second are printed as one JSON line.  It runs on the CUDA
device unless given ``--device cpu``.  Step time is the wall clock over
``--iters`` steps after ``--warmup``, the device drained before and after
(on the card also the CUDA events' time of the same steps).
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the step
(``utils/profiling.py`` ``trace_steps``).

Usage::

    python -m bigdl_torch.tools.perf --model inception_v1 --batch-size 32 \\
        [--iters 20] [--warmup 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# zoo names, resolved through models/run._build_model (LogSoftMax heads
# pair with ClassNLL, logits heads with CrossEntropy)
_MODELS = {"inception_v1": ("inception", 1000),
           "inception_v2": ("inception_v2", 1000),
           "vgg16": ("vgg16", 1000),
           "vgg19": ("vgg19", 1000), "resnet50": ("resnet50", 1000),
           "alexnet": ("alexnet", 1000), "lenet": ("lenet", 10),
           "transformer": ("transformer", 32000)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(model_name: str, batch_size: int, iters: int = 20, warmup: int = 3,
        profile_dir: str = None, num_experts: int = 0, device=None):
    from ..common import resolve_device
    from ..dataset import Sample
    from ..models.run import _build_model, build_criterion
    from ..optim import SGD, Optimizer

    device = resolve_device(device)
    zoo_name, classes = _MODELS[model_name]
    if num_experts and zoo_name != "transformer":
        raise ValueError(f"--num-experts applies to the transformer only; "
                         f"{model_name} would silently bench the dense "
                         "model")
    model, input_hw, crit = _build_model(zoo_name, classes, num_experts)
    model.build(device, torch.Generator().manual_seed(0))
    if input_hw and input_hw[0] == "tokens":  # LM: int token sequences
        _, seq, vocab = input_hw
        r = np.random.default_rng(0)
        inp = r.integers(0, vocab, (batch_size, seq)).astype(np.int32)
        tgt = r.integers(0, vocab, (batch_size, seq)).astype(np.int32)
    else:
        inp = np.random.default_rng(0).standard_normal(
            (batch_size,) + tuple(input_hw)).astype(np.float32)
        tgt = np.random.default_rng(1).integers(
            0, classes, batch_size).astype(np.float32)
    opt = Optimizer(model, [Sample(inp[0], tgt[0])], build_criterion(crit),
                    device=device)
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    params = opt._params()
    opt_state = opt.optim_method.init_state(params)
    rng = opt._dropout_generator()
    x = torch.from_numpy(inp).to(device)
    y = torch.from_numpy(tgt).to(device)
    model.train()

    def one():
        nonlocal opt_state
        loss, opt_state = opt._step(params, opt_state, x, y, 0.01, rng)
        return loss

    t0 = time.perf_counter()
    first_loss = float(one())   # the first step builds the kernels
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        one()
    _sync(device)
    events = None
    if device.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = one()
    if events is not None:
        events[1].record()
    last_loss = float(loss)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    out = {"model": model_name,
           **({"num_experts": num_experts} if num_experts else {}),
           "batch_size": batch_size, "step_seconds": dt,
           "records_per_second": batch_size / dt,
           "compile_seconds": compile_s,
           "timing": {"iters": iters, "warmup": warmup,
                      "device_step_ms": (events[0].elapsed_time(events[1])
                                         / iters if events else None),
                      "first_loss": first_loss, "last_loss": last_loss},
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else str(device))}
    if profile_dir:
        # a Chrome trace of the real step (utils/profiling.py)
        from ..utils.profiling import trace_steps
        out["profile_dir"] = trace_steps(one, max(iters // 2, 3),
                                         profile_dir)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="train-step throughput bench "
                                 "(reference: DistriOptimizerPerf)")
    ap.add_argument("--model", default="inception_v1",
                    choices=sorted(_MODELS))
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the step here")
    ap.add_argument("--num-experts", type=int, default=0,
                    help="transformer only: the Switch-style MoE "
                         "variant with this many experts "
                         "(parallel/expert.py MoEFFN)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.model, args.batch_size, args.iters,
                         args.warmup, profile_dir=args.profile_dir,
                         num_experts=args.num_experts, device=args.device)))


if __name__ == "__main__":
    main()
