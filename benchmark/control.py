"""The control of a cell's comparison, at the cell's own size:

    python3 -m benchmark.control --workload NAME --seeds 1,2,3

For each seed it makes the cell's genome and read pool as a run does, draws
the sample a run would compare (from every batch of the pool), and maps it
twice with the plain reference: as it is, and as the control (the DP's score
differences held in int4 lanes in place of int8: the step below the
configuration's int8 ksw2, breaking its guarantee of minimap2 v2.10's
alignments). The control stands in the program's place and is judged by the
run's own comparison (`run.judge`): one JSON line per seed with `correct`,
which has to come out false, and each number beside its limit. Needs no
card; the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from benchmark import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell, config, mix = R.load_cell(args.workload)
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        d = tempfile.mkdtemp(prefix="mm2ctl-")
        try:
            inputs = R.make_inputs(config, mix, seed, d)
            pool = list(read_frags(inputs["files"], inputs["batch_bases"],
                                   inputs["frag_mode"]))
            picks = R.sample(pool, set(range(len(pool))), mix["check_frags"],
                             seed)
            out = R.reference(dict(
                genome=inputs["genome"], preset=config["preset"],
                flags=config["flags"], workers=config["threads"],
                control=True,
                frags=[R.frag_job(pool[b][j]) for b, j in picks]))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        ctl = dict(zip(picks, out["control_lines"]))
        checks, _ = R.judge(pool, picks, lambda b, j: ctl[b, j],
                            out["lines"], {}, {})
        print(json.dumps(dict(
            workload=args.workload, seed=seed, sample=len(picks),
            correct=all(v <= lim for v, lim in checks.values()),
            checked={k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()},
            seconds=time.perf_counter() - t,
            reference_seconds=out["seconds"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
