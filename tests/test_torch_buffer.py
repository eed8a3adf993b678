"""The port's device-resident ItemBuffer: add, wraparound, size/cursor,
and uniform samples inside the valid prefix."""

import torch

from mfvae_tpu_torch.data.buffer import ItemBuffer, tree_leaves
from mfvae_tpu_torch.data.transitions import GroupedTransition, vae_batch_from_grouped
from mfvae_tpu_torch.models.mavae import AgentSpec


def item(v: float) -> GroupedTransition:
    return GroupedTransition(
        obs=(torch.full((2, 3), v), torch.full((1, 2), v)),
        actions=(torch.full((2,), int(v), dtype=torch.int32), torch.full((1,), int(v), dtype=torch.int32)),
        next_obs=(torch.full((2, 3), v + 0.5), torch.full((1, 2), v + 0.5)),
        rewards=torch.full((3,), v),
        done=torch.tensor(0.0),
    )


def test_add_wraps_and_counts():
    buf = ItemBuffer(max_length=4, min_length=3, sample_batch_size=5)
    st = buf.init(item(0.0))
    assert (st.cursor, st.size) == (0, 0)
    assert all(torch.all(x == 0) for x in tree_leaves(st.data))
    for v in range(1, 4):
        st = buf.add(st, item(float(v)))
    assert (st.cursor, st.size) == (3, 3) and buf.can_sample(st)
    for v in range(4, 7):
        st = buf.add(st, item(float(v)))
    assert (st.cursor, st.size) == (2, 4)
    # slots hold 5, 6, 3, 4: items 1 and 2 were overwritten
    assert st.data.rewards[:, 0].tolist() == [5.0, 6.0, 3.0, 4.0]
    assert st.data.actions[0][:, 0].tolist() == [5, 6, 3, 4]


def test_add_batch_wraps():
    buf = ItemBuffer(max_length=5, min_length=1, sample_batch_size=2)
    st = buf.init(item(0.0))
    batch = GroupedTransition(*(
        tuple(torch.stack([a, b]) for a, b in zip(x, y)) if isinstance(x, tuple) else torch.stack([x, y])
        for x, y in zip(item(1.0), item(2.0))
    ))
    for _ in range(3):
        st = buf.add_batch(st, batch)
    assert (st.cursor, st.size) == (1, 5)
    assert st.data.rewards[:, 0].tolist() == [2.0, 2.0, 1.0, 2.0, 1.0]


def test_samples_lie_in_the_valid_prefix():
    buf = ItemBuffer(max_length=100, min_length=1, sample_batch_size=64)
    st = buf.init(item(0.0))
    for v in range(1, 8):
        st = buf.add(st, item(float(v)))
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        batch = buf.sample(st, g).experience
        vals = batch.rewards[:, 0]
        assert vals.shape == (64,) and torch.all((vals >= 1) & (vals <= 7))
        seen.update(vals.tolist())
    assert seen == {float(v) for v in range(1, 8)}  # uniform: every item drawn
    assert buf.sample(st, g, batch_size=10).experience.obs[0].shape == (10, 2, 3)


def test_vae_batch_from_grouped():
    spec = AgentSpec.from_dicts(("a0", "a1", "b0"), {"a0": 3, "a1": 3, "b0": 2}, {"a0": 5, "a1": 5, "b0": 5})
    buf = ItemBuffer(max_length=4, min_length=1, sample_batch_size=6)
    st = buf.add(buf.init(item(0.0)), item(2.0))
    vb = vae_batch_from_grouped(spec, buf.sample(st, torch.Generator().manual_seed(0)).experience)
    assert vb.next_state.shape == (6, 8) and torch.all(vb.next_state == 2.5)
    assert vb.rewards.shape == (6, 3) and vb.inputs.actions[0].shape == (6, 2)
