"""pcfm_torch.kinks: a forward pass's choices at its kinks, recorded and
replayed (the card-against-CPU gradient checks of chip_smoke.py phase 20
and the bf16 parity test rest on it), on the CPU."""
import pytest

torch = pytest.importorskip("torch")

from pcfm_torch import kinks  # noqa: E402
from pcfm_torch.models import HybridMLP  # noqa: E402
from pcfm_torch.nn import pvconv  # noqa: E402
from pcfm_torch.ops import voxel_sorted  # noqa: E402

SMALL = dict(cond_dim=5, point_dim=6, ctx_dim=8, ctx_emb_dim=16,
             stage_channels=(16, 32), stage_blocks=(1, 1), stage_res=(16, 8),
             with_se=True, gn_groups=4, with_global=True, pf_width=128,
             pf_depth=3, pf_emb_dim=16)


def _hybrid_grads(net, x, t, c, ct, pins):
    for p in net.parameters():
        p.grad = None
    with pins:
        out = net.train()(x, t, c)
    (out.float() * ct).sum().backward()
    return out.detach(), {k: p.grad.clone() for k, p in
                          net.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replaying_a_pass_reproduces_it(dtype):
    """A hybrid training forward and backward replayed with its own record
    gives bitwise the same output and gradients; the record holds every
    kind of kink the hybrid has."""
    g = torch.Generator().manual_seed(0)
    net = HybridMLP(dtype=dtype, ctx_island_dtype=dtype, generator=g,
                    **SMALL)
    with torch.no_grad():
        for p in net.parameters():            # leave the zero-init start
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    x, t = torch.randn(2, 200, 6, generator=g), torch.rand(2, generator=g)
    c, ct = torch.randn(2, 5, generator=g), torch.randn(2, 200, 6,
                                                        generator=g)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    rec = kinks.Kinks()
    out, grads = _hybrid_grads(net, x, t, c, ct, kinks.record(rec))
    assert rec.counts() == {"coords": 3, "relu": 8, "leaky_relu": 4,
                            "amax": 1}
    net.load_state_dict(state)              # the running statistics too
    out2, grads2 = _hybrid_grads(net, x, t, c, ct, kinks.replay(rec))
    assert torch.equal(out, out2) and grads.keys() == grads2.keys()
    assert all(torch.equal(grads[k], grads2[k]) for k in grads)
    assert all(d == 0 for d, _ in kinks.flips(rec, rec).values())


def test_replay_takes_the_recorded_side():
    """Inputs on the other side of each kink than at recording: the
    replayed ReLU, leaky ReLU and amax pass the gradient as recorded (an
    amax splits it over the recorded elements, as over ties), and their
    values are those of the input at the recorded elements."""
    x = torch.tensor([[1.0, -2.0, 3.0, 3.0]])
    rec = kinks.Kinks()
    with kinks.record(rec):
        torch.relu(x), pvconv.leaky_relu(x, 0.1), x.amax(dim=1)
    y = torch.tensor([[-1e-8, 2.0, 3.0, 3.5]], requires_grad=True)
    with kinks.replay(rec):
        r, lk, m = torch.relu(y), pvconv.leaky_relu(y, 0.1), y.amax(dim=1)
    torch.testing.assert_close(r, torch.tensor([[-1e-8, 0.0, 3.0, 3.5]]))
    torch.testing.assert_close(lk, torch.tensor([[-1e-8, 0.2, 3.0, 3.5]]))
    torch.testing.assert_close(m, torch.tensor([3.25]))
    (r.sum() + lk.sum() + m.sum()).backward()
    torch.testing.assert_close(y.grad, torch.tensor([[2.0, 0.1, 2.5, 2.5]]))
    other = kinks.Kinks()
    with kinks.record(other):
        torch.relu(y), pvconv.leaky_relu(y, 0.1), y.amax(dim=1)
    assert kinks.flips(rec, other) == {"relu": (2, 4), "leaky_relu": (2, 4),
                                       "amax": (1, 4)}


def test_replay_pins_the_voxel_coordinates():
    pts = torch.randn(2, 50, 3, generator=torch.Generator().manual_seed(1))
    rec = kinks.Kinks()
    with kinks.record(rec):
        want = voxel_sorted.build_stage_cache(pts, 8)
    with kinks.replay(rec):
        got = voxel_sorted.build_stage_cache(pts + 0.3, 8)
    assert rec.counts() == {"coords": 1}    # the amax inside is its own
    assert torch.equal(got["vox_ids"], want["vox_ids"])
    assert torch.equal(got["norm_coords"], want["norm_coords"])


def test_replay_refuses_another_pass():
    x = torch.randn(3, 4)
    rec = kinks.Kinks()
    with kinks.record(rec):
        torch.relu(x)
    with pytest.raises(RuntimeError, match="shape"), kinks.replay(rec):
        torch.relu(torch.randn(3, 5))
    with pytest.raises(RuntimeError, match="the record has None"), \
            kinks.replay(rec):
        torch.relu(x), torch.relu(x)
    with pytest.raises(RuntimeError, match="ended before"), \
            kinks.replay(rec):
        pass
    with pytest.raises(ValueError):
        kinks.flips(rec, kinks.Kinks())


def test_patches_are_undone():
    relu, leaky = torch.relu, pvconv.leaky_relu
    coords = voxel_sorted.normalize_coords
    with pytest.raises(RuntimeError), kinks.replay(kinks.Kinks()):
        torch.relu(torch.ones(1))
    with kinks.record(kinks.Kinks()):
        assert torch.relu is not relu
    assert (torch.relu, pvconv.leaky_relu, voxel_sorted.normalize_coords) \
        == (relu, leaky, coords)
    assert "amax" not in vars(torch.Tensor)
    assert torch.ones(2).amax().item() == 1.0
