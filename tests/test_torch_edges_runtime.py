"""The four input edges of tests/test_input_edges.py on synthetic input
through TorchRuntime on its plain versions against the JAX HostRuntime,
with each edge's own contract: a lowercase query maps like its uppercase
copy apart from SEQ's case; IUPAC codes map like N apart from SEQ and the
MD/cs tags; -N 300 -p 0.1 on a tandem repeat writes more than 258 lines
for one read, which the fused flow's chain kernel took and whose native
finish grew its text buffers; -x splice --MD spans sum to the CIGAR's M
total. The CLIs' side and the helpers are tests/test_torch_edges.py."""
import pytest
import torch

from minimap2_chaindp_tpu import constants as JC
from minimap2_chaindp_tpu.index.build import build_index as jax_build
from minimap2_chaindp_tpu.io.fastx import read_frags as jax_frags
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
from minimap2_chaindp_tpu.options import set_opt as jax_opt
from minimap2_chaindp_tpu_torch import constants as C
from minimap2_chaindp_tpu_torch import native
from minimap2_chaindp_tpu_torch.index.build import build_index
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
from minimap2_chaindp_tpu_torch.options import set_opt
from test_torch_edges import LINE_SLOTS, md_covers_m, records, strip_iupac
from test_torch_options import SPLICE, make_inputs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("edges_runtime")))


def _port_and_jax(ref, preset=None, **opt):
    """(port mi, mo) and (JAX mi, mo) of `ref` under `preset`, SAM with
    CIGAR and the options in `opt` set on both."""
    recs = list(read_fastx(ref))
    names = [r.name for r in recs]
    io, mo = set_opt(preset)
    jio, jmo = jax_opt(preset)
    mi = build_index(names, [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits)
    jmi = jax_build(names, [r.seq for r in recs], jio.w, jio.k, jio.flag,
                    jio.bucket_bits)
    for m, i, c in ((mo, mi, C), (jmo, jmi, JC)):
        m.flag |= c.MM_F_OUT_SAM | c.MM_F_CIGAR
        for k, v in opt.items():
            if k == "flag":
                m.flag |= v
            else:
                setattr(m, k, v)
        m.update(i)
    return (mi, mo), (jmi, jmo)


def map_both(port, jax, reads):
    """TorchRuntime(cpu) and the JAX HostRuntime on the reads at `reads`:
    (the port's lines by read, the JAX lines by read, the port's
    counters)."""
    (mi, mo), (jmi, jmo) = port, jax
    frags = [f for b in read_frags([reads], mo.mini_batch_size, False)
             for f in b]
    jfrags = [f for b in jax_frags([reads], jmo.mini_batch_size, False)
              for f in b]
    rt = TorchRuntime(mi, mo, device="cpu", n_threads=2)
    got = rt.map_batch(frags)
    rt.close()
    return got, HostRuntime(jmi, jmo).map_batch(jfrags), rt.timers.counters


@pytest.fixture(scope="module")
def plain_index(inputs):
    return _port_and_jax(inputs["g"])


def test_lowercase_query_runtime(inputs, plain_index):
    """Lowercase reads: TorchRuntime writes HostRuntime's lines, and they
    are the uppercase reads' lines with SEQ lowercased."""
    got, want, c = map_both(*plain_index, inputs["lower"])
    assert got == want
    upper, _w, _c = map_both(*plain_index, inputs["r"])
    n_mapped = 0
    for a, b in zip(got, upper):
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            ta, tb = la.split("\t"), lb.split("\t")
            assert ta[9] == tb[9].lower()
            assert ta[:9] + ta[10:] == tb[:9] + tb[10:]
            n_mapped += not int(ta[1]) & 4
    assert n_mapped >= len(got) // 2 and c["native_finish"] > 0


def test_iupac_query_runtime(inputs, plain_index):
    """IUPAC codes: TorchRuntime writes HostRuntime's lines, and they are
    the lines of the same reads with N at those bases, apart from SEQ and
    the MD/cs tags."""
    got, want, _c = map_both(*plain_index, inputs["iupac"])
    assert got == want
    as_n, _w, _c = map_both(*plain_index, inputs["iupac_n"])
    assert any(set(ln.split("\t")[9]) & set("RYSWKMBDHV")
               for r in got for ln in r)
    for a, b in zip(got, as_n):
        assert [strip_iupac(x) for x in a] == [strip_iupac(x) for x in b]


def test_many_lines_runtime(inputs, monkeypatch):
    """-N 300 -p 0.1 on the tandem repeat: more than 258 lines for the one
    read, HostRuntime's bytes; the fused flow's chain kernel took it and
    its native finish grew the text buffers."""
    grows = []
    real = native._MapUnitCtx._grow_text

    def grow(self, code, n):
        grows.append(code)
        return real(self, code, n)
    monkeypatch.setattr(native._MapUnitCtx, "_grow_text", grow)
    ref, qry = inputs["tandem"]
    port, jax = _port_and_jax(ref, best_n=300, pri_ratio=0.1)
    got, want, c = map_both(port, jax, qry)
    assert got == want
    assert len(got) == 1 and len(records(got[0])) > LINE_SLOTS
    assert c["device_reads"] == 1 and c["native_finish"] == 1
    assert c.get("staged_frags", 0) == 0 and grows


def test_splice_md_runtime():
    """-x splice --MD on the spliced fixture: the staged path writes
    HostRuntime's lines, spliced, with MD covering the M columns."""
    port, jax = _port_and_jax(SPLICE[0], "splice", flag=C.MM_F_OUT_MD)
    got, want, c = map_both(port, jax, SPLICE[1])
    assert got == want
    recs = records([ln for r in got for ln in r])
    assert c["staged_frags"] == len(got) and c.get("ext_device", 0) > 0
    assert any("N" in ln.split("\t")[5] for ln in recs)
    assert all("MD:Z:" in ln for ln in recs if ln.split("\t")[5] != "*")
    assert all(md_covers_m(ln) for ln in recs if "MD:Z:" in ln)
