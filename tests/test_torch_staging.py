"""The host half of the served request's staging (`data/staging.py`) on the
CPU, with unpinned slots: a staged block equals what `to_torch` and
`pad_batch` give, leaf by leaf in dtype, shape and bytes, for full and
short batches and for each replica's block; a new batch signature gets a
ring of its own; the slots are resident and hold copies of the caller's
arrays. And the requests of a CPU `Predictor` all take `to_torch`."""
import numpy as np
import pytest
import torch

from egohmr_tpu_torch.data import pad_batch, synthetic_batch, to_torch
from egohmr_tpu_torch.data.staging import ALIGN, Staging, numpy_leaves
from egohmr_tpu_torch.parallel.mesh import shard_batch

B = 4


def _batch(n, points=128, seed=1):
    return synthetic_batch(n, num_scene_points=points, img_size=32, seed=seed)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_same(got, want):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.numpy().tobytes() == w.numpy().tobytes(), path


@pytest.mark.parametrize("n,blocks", [(B, 1), (3, 1), (B, 2), (1, 2)],
                         ids=["full", "short", "full-two-blocks", "short-two-blocks"])
def test_staged_block_is_the_padded_upload(n, blocks):
    """Each block of a staged batch of `n` rows equals its rows of
    `pad_batch(to_torch(batch, "cpu"), B)`, leaf for leaf, in dtype,
    shape and bytes, and a leaf's offset in its slot is aligned."""
    batch = _batch(n)
    want = pad_batch(to_torch(batch, "cpu"), B)
    rows = B // blocks
    leaves = numpy_leaves(batch, n)
    for i in range(blocks):
        staging = Staging("cpu", rows, depth=2)
        got = staging.upload(leaves, i * rows, n)
        assert got.ready is None and got.consumed is None
        _assert_same(got.batch, shard_batch((i, blocks), want))
        (ring,) = staging.rings.values()
        base = ring.host[0].data_ptr()
        assert all((t.data_ptr() - base) % ALIGN == 0 for _, t in _leaves(got.batch))


def test_read_only_and_reversed_arrays_are_staged_as_to_torch_copies_them():
    """A read-only leaf and a leaf with a negative stride (which
    `torch.from_numpy` does not take) are staged by NumPy's copy, a
    column-major one by torch's: the block equals the padded `to_torch`
    upload of the same values."""
    batch = _batch(3)
    batch["img"].flags.writeable = False
    batch["scene_pcd_verts_full"] = batch["scene_pcd_verts_full"][:, ::-1]
    batch["smpl_params"]["betas"] = np.asfortranarray(batch["smpl_params"]["betas"])
    staging = Staging("cpu", B, depth=2)
    got = staging.upload(numpy_leaves(batch, 3), 0, 3)
    dense = {**batch, "scene_pcd_verts_full": batch["scene_pcd_verts_full"].copy()}
    _assert_same(got.batch, pad_batch(to_torch(dense, "cpu"), B))


def test_a_new_signature_gets_its_own_ring():
    """A batch of another scene-point count is staged in a ring of its own
    and right; the first signature's ring is kept and reused."""
    staging = Staging("cpu", B, depth=2)
    a, b = _batch(B, points=128), _batch(B, points=64, seed=2)
    got_a = staging.upload(numpy_leaves(a, B), 0, B)
    got_b = staging.upload(numpy_leaves(b, B), 0, B)
    assert len(staging.rings) == 2
    _assert_same(got_a.batch, to_torch(a, "cpu"))
    _assert_same(got_b.batch, to_torch(b, "cpu"))
    ring_a, ring_b = staging.rings.values()
    assert ring_a.host[0].numel() != ring_b.host[0].numel()
    staging.upload(numpy_leaves(_batch(B, points=128, seed=3), B), 0, B)
    assert len(staging.rings) == 2 and ring_a.next_host == 0


def test_slots_are_resident_and_hold_copies():
    """Overwriting the caller's arrays after staging leaves the slot as it
    was staged; the ring's slots are reused in turn, not allocated anew, and
    a slot keeps its block until its turn comes round again."""
    staging = Staging("cpu", B, depth=2)
    batch = _batch(3)
    want = pad_batch(to_torch(batch, "cpu"), B)
    first = staging.upload(numpy_leaves(batch, 3), 0, 3)
    for _, x in _leaves(batch):
        x[...] = 7
    _assert_same(first.batch, want)
    second = staging.upload(numpy_leaves(_batch(B, seed=4), B), 0, B)
    _assert_same(first.batch, want)
    third = staging.upload(numpy_leaves(_batch(B, seed=5), B), 0, B)
    ptr = lambda s: s.batch["img"].data_ptr()  # noqa: E731
    assert ptr(third) == ptr(first) != ptr(second)
    _assert_same(third.batch, to_torch(_batch(B, seed=5), "cpu"))


def test_only_numpy_trees_of_the_batchs_rows_are_staged():
    """`numpy_leaves` takes a tree of NumPy arrays of the batch's rows, in
    key order; tensor leaves, other leaves and other row counts keep the
    request on `to_torch`."""
    batch = _batch(B)
    leaves = numpy_leaves(batch, B)
    assert [p for p, _ in leaves] == [p for p, _ in _leaves(batch)]
    assert numpy_leaves(to_torch(batch, "cpu"), B) is None
    assert numpy_leaves(batch, B + 1) is None
    assert numpy_leaves({**batch, "gender": list(batch["gender"])}, B) is None
    assert numpy_leaves({**batch, "note": np.zeros((), np.float32)}, B) is None
    assert numpy_leaves({**batch, "smpl_params": {}}, B) is None


def test_cpu_predictor_requests_all_take_to_torch():
    """On the CPU nothing is staged: every request, short ones too, counts
    in `unstaged`."""
    from egohmr_tpu_torch.diffusion import make_schedule
    from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig, init_random_
    from egohmr_tpu_torch.serving import Predictor
    from egohmr_tpu_torch.smpl import make_synthetic_model

    cfg = EgoHMRConfig(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
                       pointnet_hidden_dim=32, transl_embed_dim=16, timestep_embed_dim=32,
                       input_process_dim=32, gcn_hid_dim=16, gcn_layers=1)
    pred = Predictor(init_random_(EgoHMR(cfg), seed=0).eval(), cfg,
                     make_synthetic_model(num_vertices=64),
                     BodyRepStats(torch.zeros(144), torch.ones(144)),
                     make_schedule(50, "cosine", "ddim5"), device="cpu", batch_size=2,
                     pointnet_impl="xla")
    outs = list(pred.map_batches(iter([_batch(2), _batch(1)])))
    assert [o["pred_betas"].shape[0] for o in outs] == [2, 1]
    assert (pred.staged, pred.unstaged, pred.slot_waits) == (0, 2, 0)
