"""How far ``chip_smoke.py`` phase 13b's frozen W=2 step sits from the
one-process step, beside the one-process step's own spread, on a CUDA
card, for a few input seeds:

    python3 tests/ddp_w2_spread.py [TREE]

TREE is a checkout of the repo (default: this one), so that two trees can
be read in one run. For each seed it makes phase 13b's inputs
(``chip_smoke._dp_inputs``), runs the frozen full-width step in
``highest`` on all 8 images in this process three times (the inputs, the
inputs again, the images nudged by 1e-6) and once as two spawned gloo
ranks of 4 + 4 images on ``cuda:0``, and prints, as phase 13b does, each
update's error over its tensor's largest update against the first run:
the W=2 step's, the repeat's and the nudge's (max, median, worst three).
Torch only; it needs one card and ~1.5 minutes a tree.
"""

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SEEDS = (1, 2, 3)


def _rank(rank, port, inputs, out):
    """One of the two gloo ranks: the frozen step on its 4 images."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        half = cs.B // 2
        model, _, _ = cs._dp_step("frozen", slice(rank * half,
                                                  (rank + 1) * half),
                                  inputs, "cuda:0")
        if rank == 0:
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       out)
    finally:
        dist.destroy_process_group()


def _state(name, inputs):
    model, _, _ = cs._dp_step(name, inputs=inputs)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    del model
    torch.cuda.empty_cache()
    return sd, trainable


def main():
    import multiprocessing
    import tempfile

    from detectinblur_tpu_torch.utils import cuda_build

    names = [p[:-3] for p in os.listdir(os.path.join(
        ROOT, "detectinblur_tpu_torch", "csrc")) if p.endswith(".cu")]
    cuda_build.build(names)
    ctx = multiprocessing.get_context("spawn")
    for seed in SEEDS:
        inputs = cs._dp_inputs(torch.Generator(device="cuda").manual_seed(seed))
        batch, draws = inputs
        g = torch.Generator().manual_seed(14)
        nudged = (batch._replace(images=batch.images + 1e-6 * torch.randn(
            batch.images.shape, generator=g)), draws)
        p0 = {k: v.cpu() for k, v in cs._dp_model({}).state_dict().items()}
        (first, trainable), (again, _), (nudge, _) = (
            _state("frozen", x) for x in (inputs, inputs, nudged))
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "w2.pt")
            port = cs._free_port()
            procs = [ctx.Process(target=_rank, args=(r, port, inputs, out))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
                if p.is_alive():
                    p.kill()
                    sys.exit("a rank did not finish in 600 s")
            w2 = torch.load(out, weights_only=True)
        res = {}
        for name, other in (("w2", w2), ("again", again), ("nudge", nudge)):
            e = cs._update_errors(other, first, p0, trainable)
            res[name] = {"max": max(e.values()),
                         "median": float(np.median(list(e.values()))),
                         "worst": sorted(e.items(), key=lambda kv: -kv[1])[:3]}
        print(f"tree {ROOT} seed {seed}: " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
