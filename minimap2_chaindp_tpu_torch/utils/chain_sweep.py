r"""Times the chaining-DP kernel on synthetic batches at the shapes of the
port's paths and at the throughput shape (8192 reads x 1024 anchors under
map-ont's parameters), every form the wrapper can be forced to in turns
within one run, with each form's outputs held against the first form's
(and against the plain version where --plain is given). With
--longest-first every form is also timed on the same batch with its rows
sorted by falling anchor count (names ending in "+lf"): what an order
array in the kernel could gain at most, before the sort is paid for. Run
on a CUDA device:

    python -m minimap2_chaindp_tpu_torch.utils.chain_sweep \
        [--plain] [--longest-first] [--rounds N] [--forms staged,warp]

Prints one line per shape and, last, one JSON object; with --out PATH the
JSON is also written there.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from ..ops import chain_dp as TD
from ..options import set_opt
from .chain_corpus import anchors_of, pack_batch
from .synth import synth_batch, synth_read_anchors


def shapes():
    """name -> (nine numpy inputs, keywords)."""
    _, ont = set_opt("map-ont")
    _, sr = set_opt("sr")
    _, spl = set_opt("splice")
    single = dict(max_dist_x=ont.max_gap, max_dist_y=ont.max_gap, bw=ont.bw,
                  max_skip=ont.max_chain_skip, is_cdna=False,
                  many_segs=False, use_exc=True)
    out = {}
    for reads in (8192, 4096, 2048):
        out[f"bench {reads}x1024 map-ont"] = (
            pack_batch(synth_batch(reads, 1024, seed=0), 1024, ont.max_gap),
            dict(single, max_n=1024))
    # reads of uneven length, as a large batch of real reads is
    rng = np.random.default_rng(4)
    out["uneven 8192x<=1024 map-ont"] = (
        pack_batch([synth_read_anchors(rng, int(n))
                    for n in rng.integers(64, 1025, 8192)], 1024,
                   ont.max_gap),
        dict(single, max_n=1024))
    rng = np.random.default_rng(1)
    # sparse windows (some 40 candidates an anchor, as 10 kb reads against
    # a 250 Mbp genome give): the anchors spread over 250 kbp
    sparse = [synth_read_anchors(rng, int(n), read_len=250_000)
              for n in rng.integers(1100, 2047, 726)]
    out["ont-like 726x<=2046 map-ont"] = (
        pack_batch(sparse, 2048, ont.max_gap), dict(single, max_n=2048))
    # its longest reads alone on the card (one read, then one an SM): what
    # a read's dependent chain costs when nothing shares its SM
    for reads in (1, 132):
        out[f"ont-like longest {reads} alone"] = (
            pack_batch(sorted(sparse, key=len, reverse=True)[:reads], 2048,
                       ont.max_gap),
            dict(single, max_n=2048))
    # cdna-like and short-read batches at a path's size, and at four times
    # the reads, where the wrapper plans the warp form
    for reads in (1024, 4096):
        rng = np.random.default_rng(2)
        batch = []
        for n in rng.integers(300, 1025, reads):
            rp = np.sort(rng.integers(0, 120 * n, n)) + 1000
            qp = np.maximum(rp // 30 + rng.integers(-200, 200, n), 0)
            batch.append(anchors_of(rp, qp, rng.integers(13, 20, n)))
        out[f"cdna-like {reads}x<=1024 splice"] = (
            pack_batch(batch, 1024, 200000),
            dict(max_n=1024, max_dist_x=200000, max_dist_y=2000, bw=spl.bw,
                 max_skip=spl.max_chain_skip, is_cdna=True, many_segs=False,
                 use_exc=True))
    for reads in (2048, 8192):
        rng = np.random.default_rng(3)
        batch = []
        for n in rng.integers(20, 257, reads):
            rp = np.sort(rng.integers(0, 3000, n)) + 1000
            qp = np.maximum(rp + rng.integers(-200, 200, n), 0)
            batch.append(anchors_of(rp, qp, rng.integers(13, 20, n),
                                  seg=np.arange(n) >= n // 2))
        out[f"sr-like {reads}x<=256 sr"] = (
            pack_batch(batch, 256, 800),
            dict(max_n=256, max_dist_x=800, max_dist_y=600, bw=sr.bw,
                 max_skip=sr.max_chain_skip, is_cdna=False, many_segs=True,
                 use_exc=True))
    return out


def _ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def sweep(rounds: int, plain: bool, forms, longest_first: bool = False):
    rows = []
    for name, (arrs, kw) in shapes().items():
        ts = [torch.from_numpy(a).cuda() for a in arrs]
        nn = ts[6][:, 0].long()
        i = torch.arange(kw["max_n"], device="cuda")[None, :]
        pairs = int(((i - ts[5].clamp(min=0)) * (i < nn[:, None])).sum())
        anchors, longest = int(nn.sum()), int(nn.max())
        outs, times = {}, {form: [] for form in forms}
        for form in forms:
            TD.chain_scores_batch.force = form
            outs[form] = TD.chain_scores_batch(*ts, **kw)
        torch.cuda.synchronize()
        first = outs[forms[0]]
        for form, got in outs.items():
            assert all(torch.equal(g, w) for g, w in zip(got, first)), \
                f"{name}: form {form} differs from form {forms[0]}"
        if plain:
            want = TD.chain_scores_batch_ref(*ts, **kw)
            assert all(torch.equal(g, w) for g, w in zip(first, want)), \
                f"{name}: the kernel differs from the plain version"
        inputs = {"": ts}
        if longest_first:
            perm = torch.argsort(nn, descending=True, stable=True)
            inputs["+lf"] = [t[perm].contiguous() for t in ts]
            TD.chain_scores_batch.force = forms[0]
            got = TD.chain_scores_batch(*inputs["+lf"], **kw)
            assert all(torch.equal(g, w[perm]) for g, w in zip(got, first)), \
                f"{name}: sorted rows give other results"
            times.update({form + "+lf": [] for form in forms})
        for _ in range(rounds):
            for form in forms:
                TD.chain_scores_batch.force = form
                for tag, rows_in in inputs.items():
                    times[form + tag].append(_ms(
                        lambda: TD.chain_scores_batch(*rows_in, **kw)))
        TD.chain_scores_batch.force = None
        med = {str(f): statistics.median(t) for f, t in times.items()}
        rows.append(dict(shape=name, reads=len(nn), anchors=anchors,
                         longest=longest, pairs=pairs, ms=med,
                         plain_checked=plain))
        print(f"{name}: {anchors} anchors, {pairs} pairs, longest "
              f"{longest}; " + ", ".join(
                  f"{f} {t:.3f} ms ("
                  f"{anchors / t / 1e3:.1f} M anchors/s, "
                  f"{t * 1e6 / longest:.1f} ns/anchor of the longest)"
                  for f, t in med.items()), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=11)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--longest-first", action="store_true")
    ap.add_argument("--forms", default=",".join(TD.FORMS),
                    help="forms to force, in turns (default: all)")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chain_sweep needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    forms = args.forms.split(",")
    res = dict(card=card, forms=forms,
               rows=sweep(args.rounds, args.plain, forms,
                          args.longest_first))
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
