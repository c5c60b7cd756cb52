"""The roofline counts from shapes and iterations."""

import pytest

from linkbench import roofline
from linkbench.reference.code import load_code
from linkbench.spec import ASSETS

H100_ISSUE = 132 * 128 * 1980e6  # SMs x lanes x top clock: 67 TFLOP/s over 2


@pytest.mark.parametrize("nsym,m,ms", [(1152, 4, 0.0169), (576, 16, 0.0339), (384, 64, 0.0903),
                                       (1344, 64, 0.3159), (480, 16, 0.0282)])
def test_k1_count_is_the_kernel_tables(nsym, m, ms):
    """PERF.md's kernel table, bound column (B = 1024, 20 passes a row)."""
    assert roofline.k1_least_s(1024, nsym, m, 1024 * 20, H100_ISSUE) * 1e3 == pytest.approx(
        ms, abs=5e-5)


def test_k1_count_scales_with_passes_until_bytes_bound():
    ops = roofline.k1_least_s(1024, 1152, 4, 1024 * 10, H100_ISSUE)
    assert ops == pytest.approx(roofline.k1_least_s(1024, 1152, 4, 1024 * 20, H100_ISSUE) / 2)
    # one pass a row: the row's read bounds it
    assert roofline.k1_least_s(1024, 1152, 4, 0, H100_ISSUE) == pytest.approx(
        (2 * 4 * 1024 * 1152 + 2 * 4 * 1024 * 4) / 3.35e12)


@pytest.mark.parametrize("matrix,edges", [("PEG2304regular0.5.txt", 6912),
                                          ("5GLDPCBG2a3_R12_K960.txt", 7392)])
def test_decode_count(matrix, edges):
    code = load_code(str(ASSETS / matrix))
    assert code.num_edges == edges
    least = roofline.decode_least_s("flooding", edges, 1000 * 12, 1000, code.tx_len,
                                    code.info_bits, H100_ISSUE)
    assert least == pytest.approx(8 * edges * 12000 / H100_ISSUE)
    # converged at once: the LLRs' read bounds it
    least = roofline.decode_least_s("flooding", edges, 1, 1000, code.tx_len, code.info_bits,
                                    H100_ISSUE)
    assert least == pytest.approx(1000 * (4 * code.tx_len + code.info_bits) / 3.35e12)
    assert roofline.decode_least_s("unknown", edges, 1, 1, 1, 1, 1.0) is None
