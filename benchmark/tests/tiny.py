"""Tiny cells for the harness's CPU tests: the same configuration and mix
fields as benchmark/configs and benchmark/traffic, at a size the plain
PyTorch kernels map in seconds."""

GENOME = dict(contigs=3, contig_len=200_000, mask=True)
CONFIGS = {
    "ont": dict(preset="map-ont", flags=["-a"], threads=2, genome=GENOME),
    "sr": dict(preset="sr", flags=["-a"], threads=2, genome=GENOME),
    "cdna": dict(preset="splice", flags=["-a"], threads=2, genome=dict(
        GENOME, loci=dict(
            genes=6, exons=dict(median=4, mean=4.4, min=3, max=6),
            exon_len=dict(median=122, mean=145, min=60, max=300),
            intron_len=dict(median=300, mean=400, min=70, max=1200)))),
}
MIXES = {
    "ont": dict(kind="ont", batches=3, reads=3,
                length=dict(median=2000, sigma=0.6, min=500, max=6000),
                error={"rate": 0.1, "sub": 0.55, "del": 0.25},
                check_frags=100),
    "sr": dict(kind="sr_pairs", batches=3, pairs=5, read_len=150,
               insert=dict(mean=500, sd=50), max_n=0.05, error=0.02,
               mutation=dict(rate=0.001, indel=0.15, extend=0.3),
               check_frags=100),
    "cdna": dict(kind="cdna", batches=3, reads=3, zipf=1.0, skip=0.5,
                 error={"rate": 0.15, "sub": 0.10, "del": 0.30},
                 check_frags=100),
}
METRICS = ("card_chain_share_pct", "seed_ms_per_mbase",
           "staged_align_ms_per_mbase",
           "chain_roofline_pct", "ksw2_roofline_pct", "device_idle_pct")


def cell(name="tiny"):
    return dict(name=name, chips=1,
                per_layer=[dict(name=m, unit="x") for m in METRICS])
