"""The readings that a cell's correctness limits are set from: the
program's numbers on many seeds, and the control's (the reference in the
precision below the configuration's: float8 training, ``set_quant``) and,
for training, the fault of half the batch left out, on the same seeds. One process reads
them all, so the kernels build once.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... \\
        [--window 2] [--out chiprun_out/calib.jsonl]

Each seed prints one JSON line: {"seed", "program": {number: value},
"control": {...}, "half_batch": {...}}. The program's numbers come from
the cell's own run (set-up, a window of ``--window`` seconds, the check);
the others put the reference in the program's place on the same inputs.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import compare, harness, program
from benchmark.harness import sub_seed


def _det_reading(runner, model, quant: bool):
    """The detection numbers of ``model`` (the reference, in float8 when
    ``quant``) against the float32 reference on the sampled batches of
    ``runner``'s window."""
    from benchmark.reference import ops as ref_ops
    from benchmark.reference.models import set_quant

    frames = []
    for k in runner.sampled:
        blurred = ref_ops.blur(runner.frames[k].permute(0, 3, 1, 2),
                               runner.psfs[k], runner.exact).permute(0, 2, 3, 1)
        set_quant(model, False)
        ref = model.predict(blurred, runner.hw, runner.bucket)
        set_quant(model, quant)
        ctl = model.predict(blurred, runner.hw, runner.bucket)
        set_quant(model, False)
        mism = compare.detections_mismatch(
            [t.cpu().numpy() for t in ctl[:4]],
            [t.cpu().numpy() for t in ref[:4]])
        frames.extend(mism.tolist())
    return compare.detect_numbers(frames)


def _train_reading(runner, quant: bool, keep=None):
    """The training numbers of the reference put in the program's place
    (in float8 when ``quant``; the first ``keep`` images alone when given)
    against the float64 reference."""
    from benchmark.drivers.train import CHECK_STEPS
    from benchmark.reference.models import set_quant
    from benchmark.reference.train import sgd_steps

    def steps(q, k):
        state = program.start_weights(runner.cfg, sub_seed(runner.seed, 0),
                                      runner.device, runner.mix)
        model = program.reference_model(runner.cfg, state, runner.device,
                                        torch.float64)
        set_quant(model, q)
        return sgd_steps(model, runner.batches[:CHECK_STEPS],
                         runner.draws[:CHECK_STEPS], runner.bucket,
                         runner.mix["optimizer"], runner.exact, keep=k)

    ref, alt = steps(False, None), steps(quant, keep)
    return compare.train_numbers(
        alt.losses, compare.leaf_norms(alt.grad),
        compare.leaf_norms(alt.change), ref.losses,
        compare.leaf_norms(ref.grad), compare.leaf_norms(ref.change))


def main(argv=None) -> int:
    harness.cache_env()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--window", type=float, default=2.0)
    p.add_argument("--out", default=None)
    p.add_argument("--precision", default=None,
                   help="run the program in this precision instead of the "
                        "configuration's (a witness), program readings only")
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    if args.precision:
        cell.config["precision"] = args.precision
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    harness.log(f"device {torch.cuda.get_device_name(device)}; "
                f"nvidia-smi: {harness.power_limit()}")
    kind = cell.traffic["kind"]
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        runner = harness.driver(kind).Runner(cell.config, cell.traffic,
                                             cell.limits, seed, device)
        runner.setup()
        runner.window(args.window)
        verdict = runner.check()
        line = {"seed": seed, "program": verdict["numbers"]}
        if "worst_grad_leaves" in verdict:
            line["worst_grad_leaves"] = verdict["worst_grad_leaves"]
        if args.precision:
            pass
        elif kind == "detect":
            runner.sampled = verdict["sampled"]
            state = program.start_weights(runner.cfg, sub_seed(seed, 0),
                                          device, runner.mix)
            ref = program.reference_model(runner.cfg, state, device)
            line["control"] = _det_reading(runner, ref, True)
            del ref
        else:
            line["control"] = _train_reading(runner, True)
            line["half_batch"] = _train_reading(
                runner, False, keep=cell.traffic["batch"] // 2)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del runner
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
