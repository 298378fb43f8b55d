"""The port on the inputs a human reference really has, on the CPU at
tests/test_torch_scale.py's size (4 x 2 Mbp, over 2^20 keys): a masked copy
of the genome (utils/genome_synth.mask_genome: about half its bases
lowercased in runs, N gaps at the contig ends, inside and short, IUPAC
codes) and reads with N runs, single Ns, IUPAC codes and lowercase
stretches (transform_reads), reads across the gaps' edges (edge_reads).
The port's index of it, native and build_index(device="cpu"), equals the
JAX package's; lowercasing alone changes no key or position; TorchRuntime
on its plain versions writes the JAX HostRuntime's bytes under map-ont,
under -x sr for pairs with Ns and under -x splice. The generators' own
contract: the minus strand complements case, N and IUPAC codes, and an
ACGT genome gives the JAX tool's bytes."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from minimap2_chaindp_tpu import constants as JC  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index as jax_build  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_frags as jax_frags  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt as jax_opt  # noqa: E402
from minimap2_chaindp_tpu_torch import constants as C  # noqa: E402
from minimap2_chaindp_tpu_torch.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags  # noqa: E402
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime  # noqa: E402
from minimap2_chaindp_tpu_torch.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.utils import genome_synth as G  # noqa: E402

torch.set_num_threads(1)

TABLES = ("keys", "starts", "values")
N_READS, READ_LEN = 16, 4000
EDGE_LEN = 1000
PAIRS = 40
TX = 5


@pytest.fixture(scope="module")
def masked(tmp_path_factory):
    d = tmp_path_factory.mktemp("masked")
    ref = G.cached_genome(4, 2_000_000, 42)
    out = {k: str(d / f"{k}.fa") for k in ("g", "low", "raw", "edge",
                                            "reads", "sg", "tx")}
    out["info"] = G.mask_genome(ref, out["g"], seed=12)
    # the same genome lowercased in runs, with no N and no IUPAC code
    G.mask_genome(ref, out["low"], seed=12, end_gap=0, inner_gap=0,
                  short_gaps=0, iupac=0)
    G.simulate(out["g"], out["raw"], N_READS, READ_LEN, 0.10, seed=5)
    G.edge_reads(out["g"], out["edge"], EDGE_LEN, 0.10, seed=6)
    with open(out["reads"], "w") as f:
        for src in (out["raw"], out["edge"]):
            f.write(open(src).read())
    G.transform_reads(out["reads"], out["reads"] + ".t", 7, n_rate=0.002,
                      iupac_rate=0.001, run_rate=0.3, lower_rate=0.5)
    out["reads"] += ".t"
    p1, p2 = str(d / "p1.fq"), str(d / "p2.fq")
    out["truth"] = G.simulate_pairs(out["g"], p1, p2, PAIRS, seed=8)
    out["pairs"] = []
    for i, p in enumerate((p1, p2)):
        G.transform_reads(p, p + ".n", 9 + i, n_rate=0.005)
        out["pairs"].append(p + ".n")
    from chip_smoke import _write_spliced
    _write_spliced(out["g"], out["sg"], out["tx"], seed=10, genes=4,
                   transcripts=TX, intron_len=(100, 251))
    out["ref"] = ref
    return out


def _indexes(path, preset):
    """(port mi, mo) and (JAX mi, mo) of the genome at `path`."""
    recs = list(read_fastx(path))
    names = [r.name for r in recs]
    io, mo = set_opt(preset)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    mi = build_index(names, [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits)
    mo.update(mi)
    jio, jmo = jax_opt(preset)
    jmo.flag |= JC.MM_F_OUT_SAM | JC.MM_F_CIGAR
    jmi = jax_build(names, [r.seq for r in recs], jio.w, jio.k, jio.flag,
                    jio.bucket_bits)
    jmo.update(jmi)
    return (mi, mo, io, recs), (jmi, jmo)


@pytest.fixture(scope="module")
def ont(masked):
    return _indexes(masked["g"], "map-ont")


def _same_as_jax_host(port, jax, files, frag_mode=False, **kw):
    (mi, mo, _io, _r), (jmi, jmo) = port, jax
    frags = [f for b in read_frags(files, mo.mini_batch_size, frag_mode)
             for f in b]
    jfrags = [f for b in jax_frags(files, jmo.mini_batch_size, frag_mode)
              for f in b]
    rt = TorchRuntime(mi, mo, device="cpu", n_threads=2, **kw)
    got = rt.map_batch(frags)
    rt.close()
    want = HostRuntime(jmi, jmo).map_batch(jfrags)
    assert len(got) == len(want) == len(frags)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, frags[i].segs[0].name
    return got, rt.timers.counters


def test_mask_genome_has_a_references_edges(masked):
    info = masked["info"]
    assert 0.40 < info["lower"] < 0.55
    # 10 kb at both ends and 50 kb inside each contig, 3 x 100 bp
    assert info["n"] >= 4 * (2 * 10_000 + 50_000)
    assert info["iupac"] >= 4 * 6
    seqs = [r.seq for r in read_fastx(masked["g"])]
    assert all(s[:10_000] == s[-10_000:] == "N" * 10_000 for s in seqs)
    raw = "".join(seqs)
    assert set(raw) - set("ACGTNacgt") <= set(G.IUPAC + G.IUPAC.lower())
    assert set(raw) & set(G.IUPAC + G.IUPAC.lower())
    # the ACGT bases outside the gaps and codes are the source's
    src = "".join(r.seq for r in read_fastx(masked["ref"]))
    a = np.frombuffer(raw.encode(), np.uint8)
    b = np.frombuffer(src.encode(), np.uint8)
    keep = np.isin(a | 0x20, np.frombuffer(b"acgt", np.uint8))
    assert ((a[keep] & ~np.uint8(0x20)) == b[keep]).all()
    assert len(G.gap_edges(masked["g"])) >= 4 * 2


def test_simulate_complements_case_n_and_iupac(masked, tmp_path):
    """The minus strand of an error-free read is the reference's reverse
    complement of its source, case, N and IUPAC codes included (the
    generator's table complemented ACGT alone)."""
    reads = str(tmp_path / "r.fa")
    G.simulate(masked["g"], reads, 60, 3000, 0.0, seed=3)
    ref = {r.name: r.seq for r in read_fastx(masked["g"])}
    n_minus = n_low = 0
    for r in read_fastx(reads):
        _, c, st, en, strand = r.name.split("!")
        frag = ref[c][int(st):int(en)]
        if strand == "-":
            assert r.seq == C.revcomp_str(frag), r.name
            n_minus += 1
            n_low += any(ch.islower() for ch in frag)
        else:
            assert r.seq == frag
    assert n_minus > 10 and n_low > 10
    p1, p2 = str(tmp_path / "1.fq"), str(tmp_path / "2.fq")
    truth = G.simulate_pairs(masked["g"], p1, p2, 30, err=0.0)
    for (c, _s1, s2, _ins), r2 in zip(truth, read_fastx(p2)):
        assert r2.seq == C.revcomp_str(ref[c][s2:s2 + 150])


def test_simulate_on_acgt_is_the_jax_tools(tmp_path):
    """On an ACGT genome the repaired generators write the JAX tool's
    bytes (tools/genome_scale.py simulate), reads and pairs."""
    import genome_scale as JG
    g = str(tmp_path / "g.fa")
    G.make_genome(g, n_contigs=2, contig_len=50_000, seed=3)
    for mod, name in ((G, "port"), (JG, "jax")):
        mod.simulate(g, str(tmp_path / f"{name}.fa"), 30, 1000, 0.1, seed=4)
    assert open(tmp_path / "port.fa").read() == \
        open(tmp_path / "jax.fa").read()
    G.simulate_pairs(g, str(tmp_path / "1.fq"), str(tmp_path / "2.fq"), 20,
                     seed=21)
    pairs = open(tmp_path / "2.fq").read().split("\n")[1::4]
    assert all(set(p) <= set("ACGT") for p in pairs if p)


def test_transform_reads_rates(masked, tmp_path):
    src = masked["raw"]
    dst = str(tmp_path / "t.fa")
    G.transform_reads(src, dst, 3, n_rate=0.01, iupac_rate=0.005,
                      run_rate=1.0, run_len=(5, 6), lower_rate=1.0,
                      lower_len=(50, 51))
    a = list(read_fastx(src))
    b = list(read_fastx(dst))
    assert [r.name for r in a] == [r.name for r in b]
    assert [len(r.seq) for r in a] == [len(r.seq) for r in b]
    s = "".join(r.seq for r in b).upper()
    was_n = np.frombuffer("".join(r.seq for r in a).upper().encode(),
                          np.uint8) == ord("N")
    now_n = np.frombuffer(s.encode(), np.uint8) == ord("N")
    assert 0.005 < (now_n & ~was_n).mean() < 0.03
    assert sum(s.count(c) for c in G.IUPAC) > 0
    assert all("NNNNN" in r.seq.upper() for r in b)
    q = str(tmp_path / "q.fq")
    G.transform_reads(masked["pairs"][0], q, 4, n_rate=0.01)
    assert all(r.qual == "I" * len(r.seq) for r in read_fastx(q))


def test_index_equals_jax_build(ont):
    (mi, mo, io, recs), (jmi, jmo) = ont
    md = build_index([r.name for r in recs],
                     [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits, n_threads=2, device="cpu")
    for t in TABLES:
        a, b, c = getattr(mi, t), getattr(jmi, t), getattr(md, t)
        assert a.dtype == b.dtype and np.array_equal(a, b), t
        assert np.array_equal(a, c), t
    assert mo.mid_occ == jmo.mid_occ
    assert len(mi.keys) >= 1 << 20


def test_lowercase_alone_changes_no_key(masked):
    recs = {p: list(read_fastx(masked[p])) for p in ("ref", "low")}
    assert any(c.islower() for c in recs["low"][0].seq[:5000])
    io, _mo = set_opt("map-ont")
    mis = [build_index([r.name for r in rs], [C.seq_to_nt4(r.seq)
                                             for r in rs],
                       io.w, io.k, io.flag, io.bucket_bits)
           for rs in recs.values()]
    for t in TABLES:
        assert np.array_equal(getattr(mis[0], t), getattr(mis[1], t)), t


def test_map_ont_matches_jax_host(masked, ont):
    """Reads with N runs, single Ns, IUPAC codes and lowercase stretches,
    some across the gaps' edges: the fused flow, its native finish and
    the staged path on the plain versions write HostRuntime's bytes."""
    got, c = _same_as_jax_host(ont[0], ont[1], [masked["reads"]])
    names = [ln.split("\t")[0] for r in got for ln in r]
    assert any(n.startswith("e") for n in names)
    assert c["native_finish"] > 0
    mapped = [ln for r in got for ln in r if int(ln.split("\t")[1]) & 4 == 0]
    assert any(n.startswith("e") for n in (ln.split("\t")[0]
                                           for ln in mapped))


def test_sr_pairs_with_n_match_jax_host(masked):
    port, jax = _indexes(masked["g"], "sr")
    got, c = _same_as_jax_host(port, jax, masked["pairs"])
    assert c["staged_frags"] == PAIRS
    seqs = [ln.split("\t")[9] for r in got for ln in r]
    assert any("N" in s for s in seqs)


def test_splice_matches_jax_host(masked):
    port, jax = _indexes(masked["sg"], "splice")
    got, c = _same_as_jax_host(port, jax, [masked["tx"]])
    assert c["staged_frags"] == TX and c.get("ext_device", 0) > 0
    assert any("N" in ln.split("\t")[5] for r in got for ln in r)
