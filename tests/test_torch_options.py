"""The JAX package's mapping options through the port's CLI on the CPU
(`--device cpu`: the fused flow and the staged path on the plain versions)
against the JAX package's CLI on the host path (`--device host`): the same
lines apart from @PG for each option set, the cases of
tests/test_flag_differentials.py and tests/test_api_cli.py run against
the JAX package in place of the reference binary. The options that take
reads off the fused flow (--for-only, --rev-only, -X) send them through the
staged path. Then the index carried across: a .mmi written by either
package's CLI (-d) maps in the other's as the FASTA does. The output
and batching options (-c, PAF, --cs, --MD, -L, -K, -I, -G with splice)
are in tests/test_torch_options_output.py, the presets through the CLI
in tests/test_torch_options_presets.py. The cases' options are
chip_smoke.OPTION_CASES, the list that chip_smoke.py runs on the card."""
import os
import subprocess
import sys

import pytest

from minimap2_chaindp_tpu.io.fastx import read_fastx
from minimap2_chaindp_tpu_torch.utils import genome_synth as G

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import OPTION_CASES, edge_queries  # noqa: E402

PORT, JAX = "minimap2_chaindp_tpu_torch.cli", "minimap2_chaindp_tpu.cli"
SPLICE = [os.path.join(ROOT, "tests", "data", f)
          for f in ("splice_genome.fa", "splice_cdna.fa")]


def make_inputs(d):
    """{"g": genome, "r": reads, "sr": short reads, "ovl": overlapping
    reads, "asm": contigs}: a 2 x 100 kb genome (seed 81), 8 x 400 bp
    reads from it at 2% error (the staged path's plain ksw2 stays quick at
    this size), 40 x 150 bp at 1%, 6 x 1 kb reads at 2% from 3 kb of it
    (60-63 kb of the first contig, clear of its repeats), which overlap
    each other (for the self-mapping cases, as q-inv.fa against itself in
    the reference's tests), and 3 contigs of 3 kb at 0.1% divergence; and
    chip_smoke.edge_queries' inputs from the reads: "lower", "iupac",
    "iupac_n", "tandem"."""
    paths = {k: os.path.join(d, f"{k}.fa") for k in ("g", "r", "sr", "head",
                                                      "ovl", "asm")}
    if not os.path.exists(paths["asm"]):
        G.make_genome(paths["g"], n_contigs=2, contig_len=100_000, seed=81)
        G.simulate(paths["g"], paths["r"], 8, 400, 0.02, seed=85)
        seq = next(iter(read_fastx(paths["g"]))).seq
        with open(paths["head"], "w") as f:
            f.write(f">head\n{seq[60_000:63_000]}\n")
        G.simulate(paths["head"], paths["ovl"], 6, 1000, 0.02, seed=87)
        G.simulate(paths["g"], paths["sr"], 40, 150, 0.01, seed=91)
        G.simulate(paths["g"], paths["asm"], 3, 3000, 0.001, seed=89)
    paths.update(edge_queries(paths["r"], d))
    return paths


def files(inputs, queries):
    """The (reference, queries) arguments of a case's kind of queries."""
    return {"r": [inputs["g"], inputs["r"]],
            "sr": [inputs["g"], inputs["sr"]],
            "ovl": [inputs["ovl"], inputs["ovl"]],
            "asm": [inputs["g"], inputs["asm"]], "splice": SPLICE,
            "lower": [inputs["g"], inputs["lower"]],
            "iupac": [inputs["g"], inputs["iupac"]],
            "tandem": inputs["tandem"]}[queries]


def cases(ids):
    """The cases of OPTION_CASES named in `ids`, as pytest parameters."""
    return [pytest.param(opts, q, id=name) for name, opts, q in OPTION_CASES
            if name in ids]


def run_both(args, port_args=None):
    """The port's CLI (--device cpu) and the JAX CLI (--device host) on the
    same arguments, side by side in two processes. Returns ((rc, stdout,
    stderr) of the port, the same of JAX)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", mod, "--device", dev,
                               *a], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env=env)
             for mod, dev, a in ((PORT, "cpu", port_args or args),
                                 (JAX, "host", args))]
    outs = []
    for p in procs:
        out, err = p.communicate()
        outs.append((p.returncode, out, err))
    return outs


def body(stdout):
    return [ln for ln in stdout.split("\n") if not ln.startswith("@PG")]


def assert_same(args, port_args=None, min_records=1):
    (rc_p, out_p, err_p), (rc_j, out_j, err_j) = run_both(args, port_args)
    assert rc_p == 0, err_p
    assert rc_j == 0, err_j
    assert body(out_p) == body(out_j)
    assert sum(1 for ln in body(out_p) if ln and ln[0] != "@") \
        >= min_records
    timers = [ln for ln in err_p.split("\n") if ln.startswith("[timers]")]
    assert timers
    return out_p, err_p, timers[-1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("options")))


# the route options' cases: id -> a counter the port's run must show
COUNTER = {"for-only": "staged_frags", "rev-only": "staged_frags",
           "ava-X-M": "staged_frags", "pri-ratio-bestn": "device_reads",
           "secondary-no": "device_reads", "small-bw": "device_reads",
           "max-gap": "device_reads", "mid-occ-frac": "device_reads"}


@pytest.mark.parametrize("opts,qry", cases(COUNTER))
def test_option_matches_jax_cli(inputs, request, opts, qry):
    _out, _err, timers = assert_same([*opts, *files(inputs, qry)])
    counter = COUNTER[request.node.callspec.id]
    assert f" {counter}=" in timers, timers


def test_every_option_case_is_run():
    """Each case of the shared list is run by exactly one of the option
    test files (and tests/test_torch_edges.py), so the CPU runs and the
    card's cover the same cases."""
    import test_torch_edges as edges
    import test_torch_options_output as out
    import test_torch_options_presets as pre
    ids = [*COUNTER, *out.IDS, *pre.IDS, *edges.IDS]
    assert sorted(ids) == sorted(name for name, _o, _q in OPTION_CASES)


def write_mmi(module, ref, mmi):
    # the port's entry points take the card unless told otherwise
    dev = ["--device", "cpu"] if module == PORT else []
    subprocess.run([sys.executable, "-m", module, *dev, "-d", mmi, ref],
                   capture_output=True, check=True, cwd=ROOT,
                   env=dict(os.environ, JAX_PLATFORMS="cpu",
                            OMP_NUM_THREADS="1"))
    return mmi


@pytest.fixture(scope="module")
def carried(inputs, tmp_path_factory):
    """{writer module: the .mmi it wrote for the genome}, and the lines
    both CLIs write mapping the reads against the FASTA."""
    d = tmp_path_factory.mktemp("mmi")
    mmi = {m: write_mmi(m, inputs["g"], str(d / f"{i}.mmi"))
           for i, m in enumerate((PORT, JAX))}
    return mmi, assert_same(["-a", inputs["g"], inputs["r"]])[0]


@pytest.mark.parametrize("writer", [PORT, JAX], ids=["port-writes",
                                                      "jax-writes"])
def test_index_carried_across(inputs, carried, writer):
    """A .mmi written by one package's CLI (-d) maps in both packages'
    CLIs as the FASTA does."""
    mmi, fasta = carried
    out = assert_same(["-a", mmi[writer], inputs["r"]])[0]
    assert body(out) == body(fasta)


def test_index_files_equal(carried):
    """Both packages write the same .mmi bytes for the same genome."""
    mmi, _fasta = carried
    with open(mmi[PORT], "rb") as a, open(mmi[JAX], "rb") as b:
        assert a.read() == b.read()
