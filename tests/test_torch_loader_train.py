"""The port's training-time loader and dataset code against the JAX
package's, host numpy on both sides: from the same RandomState seed the
augmentation, the graph subsampling and the whole training sample are
equal bit for bit; the edge-feature scaler, dataset info, split lists and
split entries are equal on a synthetic tree of SPG files."""
import os

import numpy as np
import pytest

from superpoint_graph_tpu.data import datasets as ds_j
from superpoint_graph_tpu.data import loader as lj
from superpoint_graph_tpu.data import parsed as parsed_j
from superpoint_graph_tpu.data import spg_io as io_j
from superpoint_graph_tpu_torch.data import datasets as ds_t
from superpoint_graph_tpu_torch.data import loader as lt
from superpoint_graph_tpu_torch.data import parsed as parsed_t
from superpoint_graph_tpu_torch.data import spg_io as io_t
from superpoint_graph_tpu_torch.utils.h5io import write_spg

AUGM = dict(ptn_npts=32, ptn_minpts=6, pc_augm_scale=1.3, pc_augm_rot=True,
            pc_augm_mirror_prob=0.7, pc_augm_jitter=True, spg_augm_nneigh=12,
            spg_augm_order=2, spg_augm_hardcutoff=40)
EDGE_ATTRIBS = ("delta_avg,delta_std,nlength/ld,surface/ld,volume/ld,"
                "size/ld,xyz/d")


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _graph(rng, n, n_edges, n_classes=13):
    """A random superpoint graph in the SPG file's keys."""
    src = rng.randint(0, n, n_edges)
    tgt = (src + 1 + rng.randint(0, n - 1, n_edges)) % n
    labels = rng.randint(0, 30, (n, n_classes + 1))
    labels[rng.rand(n) < 0.1, 1:] = 0
    g = {"source": src[:, None].astype(np.uint32),
         "target": tgt[:, None].astype(np.uint32),
         "sp_labels": labels.astype(np.uint32),
         "sp_point_count": labels.sum(1).astype(np.uint64),
         "sp_centroids": rng.randn(n, 3).astype(np.float32),
         "sp_length": rng.rand(n, 1).astype(np.float32),
         "sp_surface": rng.rand(n, 1).astype(np.float32),
         "sp_volume": rng.rand(n, 1).astype(np.float32),
         "se_delta_mean": rng.randn(n_edges, 3).astype(np.float32),
         "se_delta_std": rng.rand(n_edges, 3).astype(np.float32)}
    for k in ("se_delta_norm", "se_length_ratio", "se_surface_ratio",
              "se_volume_ratio", "se_point_count_ratio"):
        g[k] = rng.rand(n_edges, 1).astype(np.float32)
    g["se_delta_centroid"] = rng.randn(n_edges, 3).astype(np.float32)
    return g


def _write_graph(path, rng, n, n_edges):
    g = _graph(rng, n, n_edges)
    comps = np.array_split(np.arange(n * 3), n)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_spg(path, g, comps, np.repeat(np.arange(n), 3))


def test_augment_cloud_bit_equal():
    rng = np.random.RandomState(0)
    P = rng.randn(50, 14).astype(np.float32)
    for kw in (AUGM, dict(AUGM, pc_augm_scale=0.0, pc_augm_mirror_prob=0.0),
               dict(AUGM, pc_augm_rot=False, pc_augm_jitter=False)):
        for seed in range(4):
            got = lt.augment_cloud(P, lt.LoaderConfig(**kw),
                                   np.random.RandomState(seed))
            want = lj.augment_cloud(P, lj.LoaderConfig(**kw),
                                    np.random.RandomState(seed))
            _assert_equal(got, want)


@pytest.mark.parametrize("n,cutoff,nneigh", [(300, 40, 12), (300, 0, 12),
                                             (30, 40, 100)])
def test_spg_subsample_bit_equal(n, cutoff, nneigh):
    """permute -> neighbourhoods -> hard cutoff, each branch on and off."""
    rng = np.random.RandomState(n + cutoff)
    g = _graph(rng, n, 4 * n)
    edges = np.concatenate([g["source"], g["target"]], 1).astype(np.int64)
    node_gt = rng.randint(0, 13, (n, 1))
    node_gt_size = g["sp_labels"].astype(np.int64)
    feats = rng.randn(len(edges), 13).astype(np.float32)
    kw = dict(AUGM, spg_augm_hardcutoff=cutoff, spg_augm_nneigh=nneigh)
    for seed in range(3):
        got = lt.spg_subsample(node_gt, node_gt_size, edges, feats,
                               lt.LoaderConfig(**kw), 6,
                               np.random.RandomState(seed))
        want = lj.spg_subsample(node_gt, node_gt_size, edges, feats,
                                lj.LoaderConfig(**kw), 6,
                                np.random.RandomState(seed))
        _assert_equal(got, want)


def test_load_spg_sample_train_bit_equal(tmp_path):
    """The whole training sample from one RandomState: the JAX loader reads
    the parsed h5 file, the port the same rows from a dict; two draws in a
    row from each state stay equal (the state advances alike)."""
    rng = np.random.RandomState(3)
    n = 120
    g = _graph(rng, n, 500)
    sizes = rng.randint(1, 80, n)
    P = rng.randn(int(sizes.sum()), 15).astype(np.float32)
    comps = np.split(np.arange(len(P)), np.cumsum(sizes)[:-1])
    path = str(tmp_path / "parsed.h5")
    parsed_t.write_parsed(path, P, comps)
    rows = parsed_t.parsed_entries(P, comps)
    entry = io_t.spg_entry(g, EDGE_ATTRIBS, "Area_1/room")
    rs_t, rs_j = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(2):
        got = lt.load_spg_sample(entry, rows, lt.LoaderConfig(**AUGM),
                                 train=True, rs=rs_t)
        want = lj.load_spg_sample(entry, path, lj.LoaderConfig(**AUGM),
                                  train=True, rs=rs_j)
        _assert_equal(got, want)
        assert (got["cloud_flag"] == -1).any() and (got["cloud_flag"] == 0).any()


def test_scaler_state_equal(tmp_path):
    """scaler01 on reader entries: scaled features, the fitted state and its
    round trip through state_dict / from_state; the superedge cutoff and
    incl_dir_in_name of spg_reader."""
    rng = np.random.RandomState(5)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / "Area_1" / f"r{i}.h5"))
        _write_graph(paths[-1], rng, 40, 150)
    for cutoff in (-1, 1.5):
        ent_t = [io_t.spg_reader(p, EDGE_ATTRIBS, cutoff, True) for p in paths]
        ent_j = [io_j.spg_reader(p, EDGE_ATTRIBS, cutoff, True) for p in paths]
        _assert_equal(ent_t, ent_j)
        assert ent_t[0][4] == "Area_1/r0"
        got = io_t.scaler01(ent_t[:2], ent_t[2:], validlist=ent_t[1:2])
        want = io_j.scaler01(ent_j[:2], ent_j[2:], validlist=ent_j[1:2])
        _assert_equal(got[:3], want[:3])
        _assert_equal(got[3].state_dict(), want[3].state_dict())
        back = io_t.EdgeFeatScaler.from_state(got[3].state_dict())
        _assert_equal(back.transform(ent_t[0][3]), got[0][0][3])
    assert len(ent_t[0][2]) < 150  # the cutoff dropped superedges


@pytest.fixture(scope="module")
def spg_tree(tmp_path_factory):
    """superpoint_graphs/ of S3DIS (six areas, validation rooms among
    them), Semantic3D and a custom dataset, plus parsed/class_count.h5."""
    root = tmp_path_factory.mktemp("spg_tree")
    rng = np.random.RandomState(7)
    rooms = {"Area_1": ["office_1", "room_a"], "Area_2": ["hallway_6"],
             "Area_3": ["room_b", "WC_2"], "Area_5": ["room_c"]}
    for area, names in rooms.items():
        for name in names:
            _write_graph(str(root / "superpoint_graphs" / area / f"{name}.h5"),
                         rng, 30, 90)
    for sub, names in (("train", ["bildstein_station1", "sg27_station4"]),
                       ("test_reduced", ["MarketplaceFeldkirch_station4"])):
        for name in names:
            _write_graph(str(root / "sema3d" / "superpoint_graphs" / sub
                             / f"{name}.h5"), rng, 30, 90)
    for sub in ("train", "test"):
        _write_graph(str(root / "custom" / "superpoint_graphs" / sub
                         / "c0.h5"), rng, 30, 90)
    parsed_t.write_class_count(str(root / "parsed" / "class_count.h5"),
                               rng.randint(0, 1000, (13, 4)))
    return root


def test_get_info_and_split_names_equal(spg_tree):
    root = str(spg_tree)
    for loss_weights in ("none", "proportional", "sqrt"):
        for cvfold in (1, 3):
            got = ds_t.get_info("s3dis", root, EDGE_ATTRIBS, "xyzrgbelpsvXYZ",
                                loss_weights, cvfold)
            want = ds_j.get_info("s3dis", root, EDGE_ATTRIBS, "xyzrgbelpsvXYZ",
                                 loss_weights, cvfold)
            _assert_equal(vars(got), vars(want))
    for dataset in ("sema3d", "vkitti", "custom_dataset"):
        _assert_equal(vars(ds_t.get_info(dataset, root, "delta_avg,constant",
                                         "")),
                      vars(ds_j.get_info(dataset, root, "delta_avg,constant",
                                         "")))
    _assert_equal(parsed_t.read_class_count(
        str(spg_tree / "parsed" / "class_count.h5")),
        parsed_j.read_class_count(str(spg_tree / "parsed" / "class_count.h5")))
    cases = [("s3dis", root, dict(cvfold=c, use_val_set=v))
             for c in (1, 3, 5) for v in (False, True)]
    cases += [("sema3d", str(spg_tree / "sema3d"),
               dict(use_val_set=v, db_train_name=tr, db_test_name=te))
              for v in (False, True) for tr in ("train", "trainval")
              for te in ("testred", "testfull", "test")]
    cases += [("custom_dataset", str(spg_tree / "custom"), {}),
              ("vkitti", root, dict(cvfold=2))]
    for dataset, r, kw in cases:
        got = ds_t.split_names(dataset, r, **kw)
        assert got == ds_j.split_names(dataset, r, **kw), (dataset, kw)
    train, test, valid = ds_t.split_names("s3dis", root, 3, True)
    assert test == ["Area_3/WC_2.h5", "Area_3/room_b.h5"]
    assert valid == ["Area_1/office_1.h5", "Area_2/hallway_6.h5"]


def test_get_datasets_equal(spg_tree):
    """Entries of every split and the fitted scaler, with and without the
    scaling and the superedge cutoff."""
    root = str(spg_tree)
    for kw in (dict(cvfold=3, use_val_set=True),
               dict(cvfold=1, spg_attribs01=False, spg_superedge_cutoff=1.0)):
        got = ds_t.get_datasets("s3dis", root, EDGE_ATTRIBS, **kw)
        want = ds_j.get_datasets("s3dis", root, EDGE_ATTRIBS, **kw)
        _assert_equal(list(got[:3]), list(want[:3]))
        if want[3] is None:
            assert got[3] is None
        else:
            _assert_equal(got[3].state_dict(), want[3].state_dict())
    assert ds_t.edge_feat_dim(EDGE_ATTRIBS) == 13
