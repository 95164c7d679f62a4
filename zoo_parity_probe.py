#!/usr/bin/env python3
"""How close the model zoo's training parity (``chip_smoke.py`` phase 28
(b)) comes to phase 8's tolerance, on one NVIDIA GPU:

    python3 zoo_parity_probe.py [--nets inceptionv3,densenet121,...]
                                [--seeds 1,2,3,4,5]

For each net (seeded ``Xavier(gaussian, in, 2)`` weights, 1000 classes)
and each seeded batch of ``PARITY_BATCH``: ``PARITY_STEPS`` SGD steps on
the card and on the CPU (the reference), Dropout masks shared as
``chip_smoke.shared_dropout`` shares them, then the CPU run under the
three batch reorderings of phase 8, run three ways: ``plain`` (phase 8's
own), ``channels_last`` (the batch in that memory format) and
``no_onednn`` (torch's own CPU convolutions in place of oneDNN's, what
phase 28 uses).  Prints, per quantity (the loss of each step, the step-1
gradients, the parameters after the last step) and way, the card's
error over the tolerance it would have: 1e-4 of each tensor's max or
twice the largest reordered spread.  A value above 1 is a failed
parity.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import chip_smoke as cs

WAYS = {"plain": {}, "channels_last": {"channels_last": True},
        "no_onednn": {"onednn": False}}


def seeded_params(mx, name, seed=7):
    """A ``.params`` file of ``name`` initialised on the card."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    shape = cs.zoo_image(name)
    net = get_model(name, classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0),
                   generator=torch.Generator(device="cuda").manual_seed(seed))
    net(mx.nd.zeros((1,) + shape, ctx=mx.gpu(0)))
    cs.BUILD.mkdir(parents=True, exist_ok=True)
    path = cs.BUILD / f"probe_{name}.params"
    net.save_parameters(str(path))
    return path


def run(name, path, x, y, device, order, channels_last=False, onednn=True):
    """``chip_smoke._train`` of the batch in ``order``; per-sample losses
    back in the original order."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    net = get_model(name, classes=1000, device=device)
    net.load_parameters(str(path))
    xb = torch.from_numpy(x[order])
    if channels_last:
        xb = xb.contiguous(memory_format=torch.channels_last)
    with cs.shared_dropout(order), torch.backends.mkldnn.flags(
            enabled=onednn):
        out = cs._train(net, xb.to(device), torch.from_numpy(y[order])
                        .to(device), cs.PARITY_STEPS)
    return [l[np.argsort(order)] for l in out[0]], out[1], out[2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nets", default=",".join(cs.ZOO_TRAIN))
    ap.add_argument("--seeds", default="1,2,3,4,5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("zoo_parity_probe: no CUDA device", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    card = cs.phase_environment()
    cs.phase_build()
    steps = cs.PARITY_STEPS
    picks = [(f"loss{i + 1}", lambda r, i=i: {"l": r[0][i]})
             for i in range(steps)]
    picks += [("grads", lambda r: r[1]), (f"params{steps}", lambda r: r[2])]
    worst = {way: 0.0 for way in WAYS}
    for name in args.nets.split(","):
        path = seeded_params(mx, name)
        for seed in (int(s) for s in args.seeds.split(",")):
            rng = np.random.RandomState(seed)
            x = rng.randn(cs.PARITY_BATCH, *cs.zoo_image(name)) \
                .astype("float32")
            y = rng.randint(0, 1000, cs.PARITY_BATCH).astype("float32")
            ident = np.arange(cs.PARITY_BATCH)
            ref = run(name, path, x, y, "cpu", ident)
            got = run(name, path, x, y, "cuda", ident)
            for way, kw in WAYS.items():
                others = [run(name, path, x, y, "cpu", p, **kw)
                          for p in cs._reorderings(cs.PARITY_BATCH)]
                parts = []
                for what, pick in picks:
                    spread = max(cs._rel(pick(o), pick(ref))[0]
                                 for o in others)
                    err, at = cs._rel(pick(got), pick(ref))
                    ratio = err / max(1e-4, 2 * spread)
                    worst[way] = max(worst[way], ratio)
                    parts.append(f"{what} {ratio:.2f}"
                                 + (f" ({at})" if ratio > 1 else ""))
                print(f"[probe] {name} batch seed {seed}, reordered runs "
                      f"{way}: card error over tolerance: "
                      + ", ".join(parts), flush=True)
    print(f"[probe] the largest over nets, batches and quantities: "
          + ", ".join(f"{w} {v:.2f}" for w, v in worst.items())
          + f"; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
