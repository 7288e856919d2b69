"""The operation counts the roofline and peak shares rest on."""
import importlib.util

import pytest

from portbench.harness import flops, manifest

SMALL = {"n_classes": 3, "model_config": "gru_2_0,f_3",
         "ptn_widths": [[4, 8], [8, 4]], "ptn_widths_stn": [[4], [4]],
         "ptn_nfeat": 3, "ptn_nfeat_stn": 3, "ptn_prelast_do": 0.0,
         "fnet_widths": [2, 4], "fnet_llbias": False, "fnet_bnidx": 0}


def test_model_forward_flops_against_a_hand_count():
    # per point: STN conv 3->4 (24), the 2x2 transform (8), convs 3->4->8
    # (24 + 64); per cloud: STN fc 4->4 (32), projection 4->4 (32), fcs
    # 9->8->4 (144 + 64); filter net 2->4->16 (16 + 128) a row; per round
    # 4x4 filters (32) an edge, ingate 4x4 + 2 x 12x4 products (32 + 192)
    # a node; head 12->3 (72) a node
    want = (5 * (7 * (24 + 8 + 88) + (32 + 32 + 208)) + 9 * 144
            + 2 * (10 * 32 + 6 * 224) + 6 * 72)
    got = flops.model_forward_flops(SMALL, n_embedded=5, n_points=7,
                                    n_nodes=6, n_edges=10, n_filter_rows=9)
    assert got == want == 10616


def test_vector_filters_count_one_product_per_channel():
    cfg = dict(SMALL, model_config="gru_1,f_3")
    got = flops.model_forward_flops(cfg, 0, 7, 6, 10, 9)
    # filter net 2->4->4 (16 + 32) a row; per edge 4 channels x 2; per node
    # 224; cat_all: head 8->3
    assert got == 9 * 48 + (10 * 8 + 6 * 224) + 6 * 2 * 8 * 3


@pytest.mark.parametrize("m,n", [(1_000_000, 1_000_000), (202_962, 1_000_000),
                                 (2_070_510, 5_000_000), (1000, 10)])
def test_nn1_bound_matches_the_smoke(m, n):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", manifest.BENCH_DIR.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ms, _ = smoke.nn1_bound_ms(m, n)
    assert flops.nn1_bound_s(m, n) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_full_width_counts_are_the_models():
    bench = manifest.load()
    cfg = manifest.config(bench, "spg-s3dis")["model"]
    # a room's batch: ~900 superpoints of 128 points, ~10k superedges
    f = flops.model_forward_flops(cfg, 900, 128, 900, 10_000, 10_000)
    assert 1e10 < f < 1e11
