"""The port keeps its own copies of the JAX package's jax-free modules
(minimap2_chaindp_tpu_torch/<same relative name>). Each copy is held against
its original: the sources may differ only in the listed lines, and the
functions the port's paths go through give equal results on seeded numpy
inputs at small size. Everything here is integers and bytes: tolerance 0."""
import difflib
import importlib
import os

import numpy as np
import pytest
import torch

import minimap2_chaindp_tpu as JP
import minimap2_chaindp_tpu_torch as TP
from minimap2_chaindp_tpu import constants as C

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR

# copied module -> lines that may differ from the original (removed +
# added): build.py sends the pair sort to the port's own
# index/build_device.py on a torch device; host_runtime.py takes the port's
# host executor and has close() (stops its -t pool)
COPIED = {
    "constants": 0, "options": 0, "esterr": 0, "sdust": 0,
    "utils.timers": 0, "utils.mlog": 0, "utils.prefetch": 0,
    "utils.synth": 0, "native": 0, "io.fastx": 0, "io.native_fastx": 0,
    "io.output": 0, "index.sketch": 0, "index.build": 9,
    "index.serialize": 0, "ops.seeds": 0, "ops.chain": 0, "ops.ksw2": 0,
    "ops.ksw2_splice": 0, "ops.ksw2_backtrack": 0, "hits": 0, "pe": 0,
    "align": 0, "models.pipeline": 0, "models.host_runtime": 10,
}
PRESETS = (None, "ava-ont", "ava-pb", "map10k", "map-pb", "map-ont", "asm5",
           "asm10", "short", "sr", "splice", "cdna")


def both(name):
    return (importlib.import_module(f"minimap2_chaindp_tpu.{name}"),
            importlib.import_module(f"minimap2_chaindp_tpu_torch.{name}"))


def _src(pkg, name):
    path = os.path.join(os.path.dirname(pkg.__file__),
                        *name.split(".")) + ".py"
    with open(path) as fh:
        return fh.read().splitlines()


@pytest.mark.parametrize("name", sorted(COPIED))
def test_copy_is_the_original(name):
    diff = [ln for ln in difflib.unified_diff(_src(JP, name), _src(TP, name),
                                              lineterm="", n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert len(diff) <= COPIED[name], "\n".join(diff)
    ours = importlib.import_module(f"minimap2_chaindp_tpu_torch.{name}")
    assert ours.__name__.startswith("minimap2_chaindp_tpu_torch.")


def _genome(n=3, length=30_000, seed=3):
    rng = np.random.default_rng(seed)
    return [f"c{i}" for i in range(n)], \
        [rng.integers(0, 4, length).astype(np.uint8) for _ in range(n)]


def _index(pkg_name, names, seqs, preset="map-ont"):
    opt = importlib.import_module(f"{pkg_name}.options")
    build = importlib.import_module(f"{pkg_name}.index.build")
    io, mo = opt.set_opt(preset)
    mi = build.build_index(names, tuple(seqs), io.w, io.k, io.flag,
                           io.bucket_bits)
    mo.update(mi)
    return mi, mo


@pytest.fixture(scope="module")
def indexes():
    names, seqs = _genome()
    return (seqs, _index("minimap2_chaindp_tpu", names, seqs),
            _index("minimap2_chaindp_tpu_torch", names, seqs))


def _read(seqs, seed, n=1500):
    rng = np.random.default_rng(seed)
    src = seqs[int(rng.integers(0, len(seqs)))]
    st = int(rng.integers(0, len(src) - n))
    r = src[st:st + n].copy()
    hit = rng.random(n) < 0.08
    r[hit] = rng.integers(0, 4, int(hit.sum()))
    return "".join("ACGT"[c] for c in r)


def test_sketch():
    a, b = both("index.sketch")
    rng = np.random.default_rng(1)
    for hpc in (False, True):
        s = rng.integers(0, 4, 5000).astype(np.uint8)
        assert np.array_equal(a.sketch(s, 10, 15, 7, hpc),
                              b.sketch(s, 10, 15, 7, hpc))


def test_build_index_tables(indexes):
    _seqs, (mi_a, mo_a), (mi_b, mo_b) = indexes
    for field in ("keys", "starts", "values", "S"):
        assert np.array_equal(getattr(mi_a, field), getattr(mi_b, field))
    assert (mi_a.k, mi_a.w, mi_a.flag, mo_a.mid_occ) == \
        (mi_b.k, mi_b.w, mi_b.flag, mo_b.mid_occ)
    assert mi_a.stat() == mi_b.stat()


def _seeds_and_chains(pkg_name, mi, mo, read):
    seeds = importlib.import_module(f"{pkg_name}.ops.seeds")
    chain = importlib.import_module(f"{pkg_name}.ops.chain")
    mv = seeds.collect_minimizers(mo, mi, [read])
    hits = seeds.collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, "q",
                                   len(read))
    ch = chain.chain_dp(mo.max_gap, mo.max_gap, mo.bw, mo.max_chain_skip,
                        mo.min_cnt, mo.min_chain_score, False, 1,
                        hits.anchors)
    return mv, hits, ch


def _arrays(obj):
    return {k: v for k, v in vars(obj).items() if isinstance(v, np.ndarray)}


def test_collect_seed_hits_and_chain_dp(indexes):
    seqs, (mi_a, mo_a), (mi_b, mo_b) = indexes
    for seed in (11, 12, 13):
        read = _read(seqs, seed)
        mv_a, hits_a, ch_a = _seeds_and_chains("minimap2_chaindp_tpu", mi_a,
                                               mo_a, read)
        mv_b, hits_b, ch_b = _seeds_and_chains("minimap2_chaindp_tpu_torch",
                                               mi_b, mo_b, read)
        assert np.array_equal(mv_a, mv_b) and len(mv_a)
        ha, hb = _arrays(hits_a), _arrays(hits_b)
        assert ha.keys() == hb.keys() and len(hits_a.anchors)
        assert all(np.array_equal(ha[k], hb[k]) for k in ha)
        ca, cb = _arrays(ch_a), _arrays(ch_b)
        assert ca.keys() == cb.keys() and ca
        assert all(np.array_equal(ca[k], cb[k]) for k in ca)


def test_chain_backtrack():
    a, b = both("ops.chain")
    rng = np.random.default_rng(5)
    n = 400
    x = np.sort(rng.integers(0, 50_000, n)).astype(np.uint64)
    y = (np.uint64(15) << np.uint64(32)) | x
    f = [int(v) for v in rng.integers(15, 400, n)]
    p = [i - 1 if i and rng.random() < 0.8 else -1 for i in range(n)]
    out_a = a.chain_backtrack(x, y, f, p, 3, 40)
    out_b = b.chain_backtrack(x, y, f, p, 3, 40)
    aa, bb = _arrays(out_a), _arrays(out_b)
    assert aa.keys() == bb.keys() and aa
    assert all(np.array_equal(aa[k], bb[k]) for k in aa)


def _ez(g):
    return (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe, g.mqe_t,
            g.mte, g.mte_q, g.reach_end, list(g.cigar))


def _pair(rng, n):
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = t.copy()
    hit = rng.random(n) < 0.1
    q[hit] = rng.integers(0, 4, int(hit.sum()))
    return np.delete(q, rng.integers(0, n, 3)), t


def test_ksw2_extd2():
    a, b = both("ops.ksw2")
    rng = np.random.default_rng(7)
    mat = a.gen_simple_mat(5, 2, 4)
    assert np.array_equal(mat, b.gen_simple_mat(5, 2, 4))
    for flag in (0, a.KSW_EZ_EXTZ_ONLY | a.KSW_EZ_RIGHT, a.KSW_EZ_APPROX_MAX):
        q, t = _pair(rng, 150)
        assert _ez(a.extd2(q, t, mat, 4, 2, 24, 1, 50, 100, 5, flag)) == \
            _ez(b.extd2(q, t, mat, 4, 2, 24, 1, 50, 100, 5, flag))


def test_ksw2_exts2():
    a, b = both("ops.ksw2_splice")
    from minimap2_chaindp_tpu.ops import ksw2 as K
    rng = np.random.default_rng(8)
    mat = K.gen_simple_mat(5, 1, 2)
    ex1, ex2 = rng.integers(0, 4, 60), rng.integers(0, 4, 60)
    intron = np.concatenate([[2, 3], rng.integers(0, 4, 90), [0, 2]])
    t = np.concatenate([ex1, intron, ex2]).astype(np.uint8)
    q = np.concatenate([ex1, ex2]).astype(np.uint8)
    for flag in (K.KSW_EZ_SPLICE_FOR, K.KSW_EZ_SPLICE_REV | K.KSW_EZ_RIGHT):
        assert _ez(a.exts2(q, t, mat, 2, 1, 32, 9, 200, flag)) == \
            _ez(b.exts2(q, t, mat, 2, 1, 32, 9, 200, flag))
        for x, y in zip(a.make_donor_acceptor(t, 9, flag),
                        b.make_donor_acceptor(t, 9, flag)):
            assert np.array_equal(x, y)


def test_decode_cigar():
    a, b = both("ops.ksw2_backtrack")
    rng = np.random.default_rng(9)
    ops = rng.choice([0, 0, 0, 1, 2, 3], 300).astype(np.int8)
    for rev in (False, True):
        for min_intron in (0, 6):
            assert list(a.decode_cigar(ops, 300, 3, -1, rev, min_intron)) \
                == list(b.decode_cigar(ops, 300, 3, -1, rev, min_intron))


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p or "default")
def test_set_opt(preset):
    a, b = both("options")
    (io_a, mo_a), (io_b, mo_b) = a.set_opt(preset), b.set_opt(preset)
    assert vars(io_a) == vars(io_b)
    assert vars(mo_a) == vars(mo_b)


def _write_fa(path, names, seqs):
    with open(path, "w") as fh:
        for n, s in zip(names, seqs):
            fh.write(f">{n}\n{''.join('ACGT'[c] for c in s)}\n")


def _pairs(seqs, p1, p2, n, seed):
    rng = np.random.default_rng(seed)
    comp = str.maketrans("ACGT", "TGCA")
    with open(p1, "w") as f1, open(p2, "w") as f2:
        for i in range(n):
            s = _read(seqs, seed * 1000 + i, n=int(rng.integers(260, 400)))
            f1.write(f">p{i}\n{s[:100]}\n")
            f2.write(f">p{i}\n{s[-100:][::-1].translate(comp)}\n")


def _host_lines(pkg_name, preset, ref, queries, frag_mode):
    opt = importlib.import_module(f"{pkg_name}.options")
    fx = importlib.import_module(f"{pkg_name}.io.fastx")
    build = importlib.import_module(f"{pkg_name}.index.build")
    hr = importlib.import_module(f"{pkg_name}.models.host_runtime")
    io, mo = opt.set_opt(preset)
    mo.flag |= SAM
    recs = list(fx.read_fastx(ref))
    mi = build.build_index([r.name for r in recs], [r.seq for r in recs],
                           io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    batches = list(fx.read_frags(queries, mo.mini_batch_size, frag_mode))
    rt = hr.HostRuntime(mi, mo, n_threads=2)
    return [ls for b in rt.map_stream(batches) for ls in b]


@pytest.mark.parametrize("mode", ["se", "splice", "pe"])
def test_host_runtime_sam_bytes(mode, tmp_path):
    if mode == "splice":
        args = ("splice", os.path.join(DATA, "splice_genome.fa"),
                [os.path.join(DATA, "splice_cdna.fa")], False)
    else:
        names, seqs = _genome(2, 40_000, seed=21)
        ref = str(tmp_path / "g.fa")
        _write_fa(ref, names, seqs)
        if mode == "se":
            reads = str(tmp_path / "r.fa")
            with open(reads, "w") as fh:
                for i in range(12):
                    fh.write(f">r{i}\n{_read(seqs, 100 + i)}\n")
            args = ("map-ont", ref, [reads], False)
        else:
            p1, p2 = str(tmp_path / "r1.fa"), str(tmp_path / "r2.fa")
            _pairs(seqs, p1, p2, 16, seed=23)
            args = ("sr", ref, [p1, p2], True)
    want = _host_lines("minimap2_chaindp_tpu", *args)
    got = _host_lines("minimap2_chaindp_tpu_torch", *args)
    assert got == want
    assert sum(len(ls) for ls in got) >= len(got) > 0
    assert any(ln.split("\t")[5] != "*" for ls in got for ln in ls)
