"""The port's FSDP machinery (``parallel/fsdp.py``) in one process, outside a
process group: a world of one keeps whole shards, so every gather and
reduce-scatter is exact and a sharded module must compute what its unsharded
twin computes bit for bit: the forward, the gradients of a backward (float32
and under bf16 autocast, whose casts of a gathered weight autograd saves as
they are), ``torch.autograd.grad`` through a frozen sharded LPIPS and
through the discriminator (which leaves the discriminator's shard without a
gradient, as the unsharded one's parameters), and the unsharded state dict,
also under a ``strict=False`` overlay. Two ranks, against the JAX package's
global-batch step: ``tests/test_torch_port_parallel.py``."""

import pytest
import torch

from generative_detection_tpu_torch.parallel import fsdp
from generative_detection_tpu_torch.train.state import fsdp_units
from tests import torch_parallel_worker as worker
from tests._torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def _twins(module_of, sd):
    """Two copies of a module on ``sd`` (channels_last), the second sharded."""
    twins = []
    for _ in range(2):
        m = module_of()
        m.load_state_dict(sd)
        twins.append(m.to(memory_format=torch.channels_last))
    return twins[0], twins[1], fsdp.shard_module(twins[1], fsdp_units(twins[1]))


@pytest.fixture(scope="module")
def pose():
    pm = worker.model("pose")
    net_sd, loss_sd = worker.init_weights(pm)
    return pm, net_sd, loss_sd


def _flat_grads(net, sharded, units):
    """The unsharded net's gradients laid out as ``sharded``'s units' flat
    shards."""
    grads = {n: p.grad for n, p in net.named_parameters()}
    out = []
    for u in units:
        parts = [grads[_full_name(sharded, u, rel)].reshape(-1) for rel in u.names]
        flat = torch.cat(parts)
        out.append(torch.cat([flat, flat.new_zeros(u.flat_shard.per_rank - flat.numel())]))
    return out


def _full_name(root, unit, rel):
    for name, m in root.named_modules():
        if m is unit.module:
            return f"{name}.{rel}" if name else rel
    raise KeyError(rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_sharded_net_computes_its_twin_bit_for_bit(pose, dtype, monkeypatch):
    """One training forward and backward of the tiny pose net: the same
    outputs and, unit by unit, the same gradients, bit for bit; autograd
    saved placeholders of gathered weights (under autocast the float32
    ones, GroupNorm's: autocast's bf16 casts are saved as they are), and
    after the backward no unit holds its gathered weights or a live
    placeholder: one gather a unit for the forward, one for the backward
    (in float32 every unit's; under autocast a unit whose every saved
    weight is a cast needs none)."""
    pm, net_sd, _ = pose
    plain, sharded, units = _twins(pm.build_net, net_sd)
    saved = {"placeholder": 0, "gathered": 0}
    pack = fsdp._pack

    def counting(t):
        out = pack(t)
        saved["placeholder"] += isinstance(out, fsdp._Saved)
        saved["gathered"] += any(t.untyped_storage().data_ptr() == p.untyped_storage().data_ptr()
                                 for u in units if u.params is not None for p in u.params)
        return out

    monkeypatch.setattr(fsdp, "_pack", counting)
    x = torch.from_numpy(worker.local_batch(pm, "pose", pm.example_batch(2))["rgb_gt"].numpy())
    got = []
    for net in (plain, sharded):
        g = torch.Generator().manual_seed(3)
        with torch.autocast("cpu", dtype=dtype, enabled=dtype != torch.float32):
            outs = net(x, 8, phase="full", generator=g)
        loss = outs["dec_obj"].float().square().mean() + outs["dec_pose"].float().square().mean()
        loss.backward()
        got.append(loss.detach())
    assert torch.equal(got[0], got[1])
    for u, want in zip(units, _flat_grads(plain, sharded, units)):
        assert torch.equal(u.flat.grad, want)
    assert 0 < saved["placeholder"] == saved["gathered"]
    regathers = [u.gathers - 1 for u in units]
    assert all(not u.held() and u.pending == 0 for u in units)
    if dtype == torch.float32:
        assert regathers == [1] * len(units)
    else:
        assert set(regathers) <= {0, 1} and 1 in regathers
    assert all(getattr(o, a).device.type == "meta" for u in units for o, a, _ in u.slots)


def test_autograd_grad_through_frozen_and_trained_units(pose):
    """``torch.autograd.grad`` with respect to an input leaf through the
    sharded LPIPS (frozen) and discriminator: the unsharded twins' input
    gradients bit for bit, the units gathered again for the backward and
    released, and no gradient on either module's shards."""
    pm, _, loss_sd = pose

    def part(name):
        prefix = name + "."
        sd = {k[len(prefix):]: v for k, v in loss_sd.items() if k.startswith(prefix)}
        return _twins(lambda: getattr(pm.build_loss(), name), sd)

    g = torch.Generator().manual_seed(5)
    a, b = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1, torch.rand(2, 32, 32, 3, generator=g)
    for name, call in (("perceptual_loss", lambda m, y: m(a, y).sum()),
                       ("discriminator", lambda m, y: m(y).square().sum())):
        plain, sharded, units = part(name)
        grads = []
        for m in (plain, sharded):
            y = b.clone().requires_grad_(True)
            (gy,) = torch.autograd.grad(call(m, y), y)
            grads.append(gy)
        assert torch.equal(grads[0], grads[1]), name
        assert all(u.flat.grad is None and not u.held() and u.gathers == 2 for u in units), name


def test_state_dicts_stay_unsharded(pose):
    """A sharded net's ``state_dict`` is the unsharded one's: the same keys
    in the same order, the same values and strides. ``load_state_dict``
    takes an unsharded state dict back into the shards; under
    ``strict=False`` a subset of a unit's keys overlays that unit and the
    rest are reported missing; a shape that differs raises."""
    pm, net_sd, _ = pose
    plain, sharded, units = _twins(pm.build_net, net_sd)
    want = plain.state_dict()
    got = sharded.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v) and got[k].stride() == v.stride(), k
    fresh = pm.build_net()
    fsdp.shard_module(fresh, fsdp_units(fresh))
    fresh.load_state_dict(got)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), want.values()))
    key = "encoder.down.0.block.0.conv1.weight"
    missing, unexpected = fresh.load_state_dict({key: want[key] + 1.0}, strict=False)
    after = fresh.state_dict()
    assert torch.equal(after[key], want[key] + 1.0) and not unexpected
    assert key not in missing and "encoder.down.0.block.0.conv1.bias" in missing
    assert all(torch.equal(after[k], v) for k, v in want.items() if k != key)
    with pytest.raises(RuntimeError, match="size mismatch"):
        fresh.load_state_dict({**want, key: torch.zeros(1)})


def test_flat_shard_partitions_every_element():
    """Three tensors of 5, 3 and 9 elements over four ranks: shards of
    ceil(17 / 4) = 5 elements, disjoint, in rank order the tensors' elements
    end to end, the last padded with zeros; ``write`` lays a flat tensor back
    out."""
    ts = [torch.arange(5.0), torch.arange(10.0, 13.0), torch.arange(20.0, 29.0).reshape(3, 3)]
    flat = torch.cat([t.reshape(-1) for t in ts])
    shards = [fsdp.FlatShard([5, 3, 9], r, 4) for r in range(4)]
    assert [s.shard_range for s in shards] == [(0, 5), (5, 10), (10, 15), (15, 17)]
    assert torch.equal(torch.cat([s.slice(ts) for s in shards]), flat)
    padded = [s.padded(ts) for s in shards]
    assert all(p.numel() == 5 for p in padded)
    assert torch.equal(torch.cat(padded), torch.cat([flat, flat.new_zeros(3)]))
    out = [torch.empty_like(t) for t in ts]
    shards[0].write(out, flat)
    assert all(torch.equal(a, b) for a, b in zip(out, ts))


def test_fsdp_optimizer_state_moves_to_and_from_unsharded(pose):
    """``ClippedAdam`` over a sharded net's flat shards (``layout``) against
    the unsharded optimizer over its twin, through an accumulation window of
    two, without the clip (whose float32 norm sums its squares grouped by
    unit rather than by parameter: 9e-6 apart here, both 2.5e-5 from the
    float64 norm): inside the window its ``state_dict`` holds the twin's
    summed gradients in the unsharded layout, after it the twin's Adam
    moments, bit for bit, and each optimizer's ``state_dict`` loads into the
    other."""
    from generative_detection_tpu_torch.train.state import ClippedAdam

    pm, net_sd, _ = pose
    plain, sharded, _ = _twins(pm.build_net, net_sd)
    opts = [ClippedAdam(plain.parameters(), 1e-4, grad_clip=None, accumulate=2),
            ClippedAdam(sharded.parameters(), 1e-4, grad_clip=None, accumulate=2,
                        layout=fsdp.layout(sharded))]
    assert opts[1].fsdp and not opts[0].fsdp
    g = torch.Generator().manual_seed(7)
    xs = [torch.rand(2, 32, 32, 3, generator=g) * 2 - 1 for _ in range(2)]
    sds = []
    for i, x in enumerate(xs):
        for net, opt in zip((plain, sharded), opts):
            opt.zero_grad()
            outs = net(x, 8, phase="full", generator=torch.Generator().manual_seed(i))
            (outs["dec_obj"].square().mean() + outs["dec_pose"].square().mean()).backward()
            opt.step()
        sds.append([opt.state_dict() for opt in opts])
    (want, got), _ = sds
    assert want["mini_step"] == got["mini_step"] == 1
    assert all(torch.equal(a, b) for a, b in zip(want["grads"], got["grads"]))
    want, got = sds[1]
    assert set(want["adam"]["state"]) == set(got["adam"]["state"])
    for i, st in want["adam"]["state"].items():
        assert all(torch.equal(got["adam"]["state"][i][k], st[k])
                   for k in ("exp_avg", "exp_avg_sq")), i
    back = [ClippedAdam(sharded.parameters(), 1e-4, layout=fsdp.layout(sharded)),
            ClippedAdam(plain.parameters(), 1e-4)]
    back[0].load_state_dict(want)
    back[1].load_state_dict(got)
    for opt, sd in zip(back, (want, got)):
        for i, st in opt.state_dict()["adam"]["state"].items():
            assert all(torch.equal(st[k], sd["adam"]["state"][i][k])
                       for k in ("exp_avg", "exp_avg_sq")), i
