"""``kernels.adam_update_``, the in-place Adam pass of one leaf: its input
checks, the plain version taken on the CPU and meta, ``adam(...).update_``
bit for bit against the functional ``update`` on the CPU, and on a CUDA
card (marker ``cuda``, skipped without one) the kernel bit for bit against
its plain version with one launch a leaf:

    PYTHONPATH=src python -m pytest tests/test_torch_adam_kernel.py -m cuda -q
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import training  # noqa: E402
from repro_torch.kernels import adam_update_, adam_update_ref_, launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.utils.tree import tree_leaves as _leaves  # noqa: E402

adam_kernel = importlib.import_module("repro_torch.kernels.adam")

HP = dict(b1=0.9, b2=0.999, eps=1e-8, lr_t=3e-2, mh_scale=10.0, vh_scale=1000.0)


def _leaf(n, seed, dtype=torch.float32, device="cpu", scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(n) * scale, dtype=torch.float32).to(device=device, dtype=dtype)


def _quad(n=10, dtype=torch.float32, mdt=torch.float32, device="cpu"):
    return (_leaf(n, 0, dtype, device), _leaf(n, 1, dtype, device),
            _leaf(n, 2, mdt, device, 0.1), _leaf(n, 3, mdt, device, 0.1).abs())


def _bad_shape():
    p, g, m, v = _quad()
    return p, g[:9], m, v


def _bad_contiguity():
    p, g, m, v = _quad(12)
    return p.view(3, 4), g.view(4, 3).t(), m.view(3, 4), v.view(3, 4)


def _bad_dtype():
    p, g, m, v = _quad()
    return p.double(), g, m, v


def _half_grad():
    p, g, m, v = _quad()
    return p, g.half(), m, v


def _mixed_moments():
    p, g, m, v = _quad()
    return p, g, m, v.bfloat16()


def _mixed_devices():
    p, g, m, v = _quad()
    return p, g.to("meta"), m, v


@pytest.mark.parametrize("make, error", [
    (_bad_shape, ValueError), (_bad_contiguity, ValueError), (_bad_dtype, TypeError), (_half_grad, TypeError),
    (_mixed_moments, TypeError), (_mixed_devices, ValueError),
], ids=["shape", "contiguity", "float64_params", "float16_grads", "mixed_moments", "mixed_devices"])
def test_wrapper_refuses_what_the_kernel_does_not_take(make, error):
    p, g, m, v = make()
    before = [t.clone() if t.device.type == "cpu" else None for t in (p, m, v)]
    with pytest.raises(error):
        adam_update_(p, g, m, v, **HP)
    for t, b in zip((p, m, v), before, strict=True):
        assert b is None or torch.equal(t, b)  # refused before anything was written


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_devices_take_the_plain_version(device):
    reset_launch_counts()
    p, g, m, v = _quad(37, torch.bfloat16, device=device)
    want = [t.clone() for t in (p, g, m, v)]
    adam_update_(p, g, m, v, weight_decay=0.1, **HP)
    adam_update_ref_(*want, weight_decay=0.1, **HP)
    assert launch_counts()["adam_update"] == 0
    if device == "cpu":
        for a, b in zip((p, m, v), (want[0], want[2], want[3]), strict=True):
            assert torch.equal(a, b)
    else:
        assert {t.device.type for t in (p, m, v)} == {"meta"}


def test_reset_zeroes_the_count():
    adam_update_.launches = 3
    assert launch_counts()["adam_update"] == 3
    reset_launch_counts()
    assert launch_counts()["adam_update"] == 0


def _tree(seed, dtype):
    """Leaves of 13, 64 and 1 elements: with ``_SLICE`` 8, a leaf over one
    slice, one of whole slices and one shorter than a slice."""
    rng = np.random.default_rng(seed)
    make = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32).to(dtype)  # noqa: E731
    return {"a": {"w": make(13)}, "b": (make(8, 8), make(1))}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1], ids=["wd0", "wd0.1"])
@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16], ids=["m_fp32", "m_bf16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16], ids=["p_fp32", "p_bf16"])
def test_update_inplace_is_update_bit_for_bit(param_dtype, moment_dtype, weight_decay, monkeypatch):
    """``update_`` through ``adam_update_`` writes what the functional
    ``update`` returns, bit for bit, in the leaves' own storage, under a
    schedule and across slice boundaries."""
    monkeypatch.setattr(adam_kernel, "_SLICE", 8)
    opt = training.adam(3e-2, weight_decay=weight_decay, schedule=training.cosine_schedule(6, warmup=1),
                        moment_dtype=moment_dtype)
    functional = _tree(0, param_dtype)
    inplace = _tree(0, param_dtype)
    fs, ist = opt.init(functional), opt.init(inplace)
    storage = [t.data_ptr() for t in _leaves((inplace, ist))]
    for step in range(4):
        g = _tree(10 + step, param_dtype)
        functional, fs = opt.update(functional, g, fs, step)
        opt.update_(inplace, g, ist, step)
        for a, b in zip(_leaves((functional, fs)), _leaves((inplace, ist)), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert storage == [t.data_ptr() for t in _leaves((inplace, ist))]
    assert {t.dtype for t in _leaves(ist)} == {moment_dtype}


# -- on the card ---------------------------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("combo", ["fp32/fp32/fp32", "bf16/bf16/fp32", "bf16/fp32/bf16", "fp32/bf16/bf16"])
def test_kernel_is_the_plain_version_bit_for_bit_on_card(cuda, combo, offset):
    """A ragged length (8 k + 5), at 16-byte aligned pointers and at
    pointers one element off, with weight decay and without: the kernel
    writes the plain version's p, m and v, one launch a call."""
    pdt, gdt, mdt = (DTYPES[s] for s in combo.split("/"))
    n = 8 * 4099 + 5

    def views():
        bufs = [_leaf(n + offset, i, dt, cuda, sc) for i, (dt, sc) in enumerate(
            ((pdt, 1.0), (gdt, 1.0), (mdt, 0.1), (mdt, 0.1)))]
        bufs[3].abs_()
        return [b[offset:] for b in bufs]

    for wd in (0.0, 0.1):
        kern, plain = views(), views()
        assert (kern[0].data_ptr() % 16 == 0) == (offset == 0)
        reset_launch_counts()
        adam_update_(*kern, weight_decay=wd, **HP)
        adam_update_ref_(*plain, weight_decay=wd, **HP)
        torch.cuda.synchronize()
        assert launch_counts()["adam_update"] == 1
        for a, b in zip(kern, plain, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_update_inplace_launches_once_a_leaf_on_card(cuda):
    """``adam(...).update_`` on CUDA leaves: one launch a leaf a step, and
    the functional ``update``'s bits (bf16 parameters, fp32 moments)."""
    opt = training.adam(1e-3)
    to = lambda tree: {k: (tuple(x.to(cuda) for x in v) if isinstance(v, tuple)  # noqa: E731
                           else {kk: x.to(cuda) for kk, x in v.items()}) for k, v in tree.items()}
    functional, inplace = to(_tree(0, torch.bfloat16)), to(_tree(0, torch.bfloat16))
    fs, ist = opt.init(functional), opt.init(inplace)
    reset_launch_counts()
    for step in range(3):
        g = to(_tree(10 + step, torch.bfloat16))
        functional, fs = opt.update(functional, g, fs, step)
        opt.update_(inplace, g, ist, step)
    torch.cuda.synchronize()
    assert launch_counts()["adam_update"] == 3 * len(_leaves(inplace))
    for a, b in zip(_leaves((functional, fs)), _leaves((inplace, ist)), strict=True):
        assert torch.equal(a, b)
