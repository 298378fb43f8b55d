"""Paired-end ground truth by construction through the port, the four
behaviours of tests/test_pe_truth.py (which reads a reference tree) on a
utils/genome_synth genome under -x sr: FR pairs simulated with known
positions and inserts (genome_synth.simulate_pairs) are flagged proper
with the mates' fields and TLEN of the construction; forward-forward pairs
map but are never proper; mates far beyond the fragment bound are not
proper; and the port's runtime agrees with the truth and with both
packages' HostRuntime. Every run is TorchRuntime on its plain versions
(the staged path: many-segment chaining, extd2 on the walk) and is held
byte for byte against the JAX HostRuntime."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from minimap2_chaindp_tpu import constants as JC  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index as jax_build  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_frags as jax_frags  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import \
    HostRuntime as JaxHost  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt as jax_opt  # noqa: E402
from minimap2_chaindp_tpu_torch import constants as C  # noqa: E402
from minimap2_chaindp_tpu_torch.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags  # noqa: E402
from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime  # noqa: E402
from minimap2_chaindp_tpu_torch.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.utils import genome_synth as G  # noqa: E402

torch.set_num_threads(1)

READ_LEN = 100
INSERT = (250, 450)


@pytest.fixture(scope="module")
def sr(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe_truth")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=150_000, seed=77)
    recs = list(read_fastx(ref))
    names = [r.name for r in recs]
    io, mo = set_opt("sr")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    mi = build_index(names, [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits)
    mo.update(mi)
    jio, jmo = jax_opt("sr")
    jmo.flag |= JC.MM_F_OUT_SAM | JC.MM_F_CIGAR
    jmi = jax_build(names, [r.seq for r in recs], jio.w, jio.k, jio.flag,
                    jio.bucket_bits)
    jmo.update(jmi)
    return dict(d=d, ref=ref, seq=recs[0].seq, name=recs[0].name, mi=mi,
                mo=mo, jmi=jmi, jmo=jmo)


def _mutate(rng, s, err=0.005):
    return "".join("ACGT"[int(rng.integers(0, 4))] if rng.random() < err
                   else c for c in s)


def _write_pairs(sr, tag, pairs):
    """FASTQ files of the (read 1, read 2) strings `pairs`."""
    paths = [str(sr["d"] / f"{tag}_{i}.fq") for i in (1, 2)]
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for i, (a, b) in enumerate(pairs):
            f1.write(f"@{tag}{i}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@{tag}{i}\n{b}\n+\n{'I' * len(b)}\n")
    return paths


def _map(sr, paths):
    """TorchRuntime(cpu) on the pairs at `paths`, held against the JAX
    HostRuntime byte for byte; the records of each pair, split."""
    mo, jmo = sr["mo"], sr["jmo"]
    frags = [f for b in read_frags(paths, mo.mini_batch_size, False)
             for f in b]
    jfrags = [f for b in jax_frags(paths, jmo.mini_batch_size, False)
              for f in b]
    rt = TorchRuntime(sr["mi"], mo, device="cpu", n_threads=2)
    got = rt.map_batch(frags)
    rt.close()
    assert got == JaxHost(sr["jmi"], jmo).map_batch(jfrags)
    assert rt.timers.counters["staged_frags"] == len(frags)
    return got, [[ln.split("\t") for ln in lines if ln and ln[0] != "@"]
                 for lines in got], frags


def _truth_pairs(sr, n, seed):
    paths = [str(sr["d"] / f"truth{seed}_{i}.fq") for i in (1, 2)]
    truth = G.simulate_pairs(sr["ref"], *paths, n, seed=seed,
                             read_len=READ_LEN, insert=INSERT)
    return paths, truth


def test_pe_proper_pairs_by_construction(sr):
    """Proper FR pairs carry the construction's orientation, mate fields
    and TLEN; where both mates are placed uniquely (MAPQ > 0: the genome
    has repeat families, segmental duplications and microsatellites,
    which a reference's MT genome has not), its positions."""
    paths, truth = _truth_pairs(sr, 30, 77)
    _lines, recs, _f = _map(sr, paths)
    n_proper = n_unique = 0
    for fi, rows in enumerate(recs):
        _c, st1, st2, ins = truth[fi]
        prim = [t for t in rows if not (int(t[1]) & 0x900)]
        assert len(prim) == 2, f"pair {fi}: {len(prim)} primary records"
        a = next(t for t in prim if int(t[1]) & 0x40)   # first in pair
        b = next(t for t in prim if int(t[1]) & 0x80)   # second in pair
        fa, fb = int(a[1]), int(b[1])
        assert fa & 0x1 and fb & 0x1
        if not fa & 0x2:
            continue
        n_proper += 1
        assert fb & 0x2
        # FR by construction: read 1 forward, read 2 reverse
        assert not fa & 0x10 and fa & 0x20
        assert fb & 0x10 and not fb & 0x20
        assert a[6] == "=" and b[6] == "="
        assert int(a[7]) == int(b[3]) and int(b[7]) == int(a[3])
        assert int(a[8]) == -int(b[8]) > 0
        if int(a[4]) and int(b[4]):
            n_unique += 1
            assert a[2] == b[2] == truth[fi][0]
            assert abs(int(a[3]) - 1 - st1) <= 8
            assert abs(int(b[3]) - 1 - st2) <= 8
            assert abs(int(a[8]) - ins) <= 16
    assert n_proper >= 27, f"only {n_proper}/30 proper pairs"
    assert n_unique >= 22, f"only {n_unique}/30 unique proper pairs"


def test_pe_orientation_rejected(sr):
    """Forward-forward pairs violate the FR model: they map, never as
    proper pairs."""
    rng = np.random.default_rng(3)
    seq = sr["seq"]
    pairs = []
    for _ in range(10):
        st = int(rng.integers(0, len(seq) - 400))
        pairs.append((_mutate(rng, seq[st:st + 100]),
                      _mutate(rng, seq[st + 300:st + 400])))
    _lines, recs, _f = _map(sr, _write_pairs(sr, "ff", pairs))
    prim = [t for rows in recs for t in rows if not int(t[1]) & 0x900]
    assert sum(1 for t in prim if not int(t[1]) & 0x4) >= 15
    assert not any(int(t[1]) & 0x2 for t in prim)


def test_pe_distant_mates_not_proper(sr):
    """Mates far beyond the fragment bound are not proper pairs."""
    rng = np.random.default_rng(9)
    seq = sr["seq"]
    pairs = []
    for _ in range(10):
        st1 = int(rng.integers(0, 20_000))
        st2 = int(rng.integers(100_000, len(seq) - 120))
        pairs.append((_mutate(rng, seq[st1:st1 + 100]),
                      C.revcomp_str(_mutate(rng, seq[st2:st2 + 100]))))
    _lines, recs, _f = _map(sr, _write_pairs(sr, "far", pairs))
    prim = [t for rows in recs for t in rows if not int(t[1]) & 0x900]
    assert sum(1 for t in prim if not int(t[1]) & 0x4) >= 15
    assert not any(int(t[1]) & 0x2 for t in prim)


def test_pe_truth_matches_runtime(sr):
    """The port's runtime agrees with the construction and with both
    packages' HostRuntime."""
    paths, truth = _truth_pairs(sr, 16, 13)
    lines, recs, frags = _map(sr, paths)
    assert lines == HostRuntime(sr["mi"], sr["mo"]).map_batch(frags)
    placed = unique = 0
    for (c, st1, st2, _ins), rows in zip(truth, recs):
        prim = {int(t[1]) & 0xC0: t for t in rows
                if not int(t[1]) & 0x904}
        if 0x40 in prim and 0x80 in prim and int(prim[0x40][4]) \
                and int(prim[0x80][4]):
            unique += 1
            placed += (prim[0x40][2] == prim[0x80][2] == c
                       and abs(int(prim[0x40][3]) - 1 - st1) <= 8
                       and abs(int(prim[0x80][3]) - 1 - st2) <= 8)
    assert unique >= 12 and placed == unique, (placed, unique)
