"""kmldpc_torch tables against kmldpc_tpu's: decoder, modem, encoder, params."""

import jax
import numpy as np
import pytest
import torch

from kmldpc_tpu.decoder.bp import DecoderTables as JaxDecoderTables
from kmldpc_tpu.ops.encode import encoder_table as jax_encoder_table
from kmldpc_tpu.ops.modem import ModemTables as JaxModemTables
from kmldpc_tpu.sim.chain import ChainSpec as JaxChainSpec
from kmldpc_tpu.sim.chain import make_chain_params as jax_make_chain_params
from kmldpc_torch.code import load_code
from kmldpc_torch.decoder import DecoderTables
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.ops import ModemTables, encoder_table
from kmldpc_torch.params import from_jax_params, make_chain_params

CODES = ["PEG2304regular0.5.txt", "PEG8064regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt"]
TABLES = [
    "2bits_4PSK.txt", "2bits_QPSK.txt", "4bit_16QAM_Gray.txt",
    "4bit_16QAM_phi1.txt", "4bit_16QAM_phi2.txt", "6bits_64QAM_Gray.txt",
]
DEC_ARRAYS = ["perm_sm_c2r", "row_edge_col", "col_sort", "col_unsort", "row_unsort",
              "perm_cf_c2r", "row_col_cf"]
DEC_STATIC = ["num_col", "num_row", "num_edges", "code_dim", "punct", "is_5g", "info_start",
              "dc", "dr", "col_classes", "row_classes"]


@pytest.fixture(autouse=True)
def _one_thread():
    # one thread per worker process, restored after the test: other test
    # files share the worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_dec_equal(ours: DecoderTables, ref) -> None:
    assert set(DEC_STATIC + DEC_ARRAYS) == set(DecoderTables.HOST_FIELDS)
    for f in DEC_STATIC:
        assert getattr(ours, f) == getattr(ref, f), f
    for f in DEC_ARRAYS:
        np.testing.assert_array_equal(
            getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f
        )
    np.testing.assert_array_equal(
        ours.row_col_sm.numpy(), np.asarray(ref.row_edge_col).T.reshape(-1)
    )


@pytest.mark.parametrize("fname", CODES)
def test_decoder_tables_equal_jax(assets, fname):
    code = load_code(str(assets / fname))
    _assert_dec_equal(DecoderTables.from_code(code), JaxDecoderTables.from_code(code))


@pytest.mark.parametrize("fname", CODES)
def test_encoder_table_equal_jax(assets, fname):
    code = load_code(str(assets / fname))
    np.testing.assert_array_equal(
        encoder_table(code).numpy(), np.asarray(jax_encoder_table(code))
    )


@pytest.mark.parametrize("fname", TABLES)
def test_modem_tables_equal_jax(assets, fname):
    c = parse_constellation(str(assets / fname))
    ours, ref = ModemTables.from_constellation(c), JaxModemTables.from_constellation(c)
    assert ours.bits_per_symbol == ref.bits_per_symbol
    assert ours.num_points == ref.num_points
    for f in ("points_re", "points_im", "bit0_mask", "pack_weights"):
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.dtype == torch.float32 and b.dtype == np.float32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


@pytest.mark.parametrize("fname", CODES)
def test_from_jax_params(assets, fname):
    code = load_code(str(assets / fname))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = JaxChainSpec(
        code=code, constellation=const, known_h=False, fading=True,
        metric_type=False, metric_iter=5, max_iter=50, encoder_active=True,
        histogram=False,
    )
    np_params = jax.tree.map(np.asarray, jax_make_chain_params(spec))
    ours = from_jax_params(np_params)
    np.testing.assert_array_equal(ours.gen_t.numpy(), np_params.gen_t)
    _assert_dec_equal(ours.dec, np_params.dec)
    direct = make_chain_params(code)
    np.testing.assert_array_equal(ours.gen_t.numpy(), direct.gen_t.numpy())
    _assert_dec_equal(direct.dec, np_params.dec)


def test_5g_tables(assets):
    """The 5G BG2 K=960 code: 2Z = 192 punctured columns, info first, seven
    column and five row degree classes that hold every edge once."""
    t = DecoderTables.from_code(load_code(str(assets / "5GLDPCBG2a3_R12_K960.txt")))
    assert (t.num_col, t.num_row, t.num_edges, t.punct, t.info_start) == (2112, 1152, 7392, 192, 0)
    assert t.is_5g and not t.is_regular
    assert [d for d, _ in t.col_classes] == [1, 2, 3, 4, 5, 7, 9]
    assert [d for d, _ in t.row_classes] == [4, 5, 6, 8, 10]
    for classes, nodes in ((t.col_classes, t.num_col), (t.row_classes, t.num_row)):
        assert sum(n for _, n in classes) == nodes
        assert sum(d * n for d, n in classes) == t.num_edges
    assert torch.equal(torch.sort(t.perm_cf_c2r).values, torch.arange(t.num_edges))
    assert torch.equal(t.col_sort[t.col_unsort], torch.arange(t.num_col))
