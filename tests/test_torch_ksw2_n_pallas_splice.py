"""The port's plain ksw2 versions on base code 4 against the Pallas
kernel in interpret mode with its fused walk: the exts2 case of
chip_smoke.ambiguous_ksw_cases() cut to small jobs (N at every intron's
donor or acceptor G, inside introns and exons; the helpers and the extd2
cases are tests/test_torch_ksw2_n_pallas.py)."""
import pytest

from test_torch_ksw2_n_pallas import SMALL, check_against_pallas


@pytest.mark.parametrize("case", sorted(k for k, v in SMALL.items() if v[2]))
def test_plain_matches_pallas_with_n(monkeypatch, case):
    check_against_pallas(monkeypatch, case)
