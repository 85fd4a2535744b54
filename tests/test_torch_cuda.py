"""Card-only tests of the port: the CUDA kernels against their plain PyTorch
versions, and the engine on the card against the engine on the CPU.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports only torch, numpy and the port — the
machine with the card has no JAX — so run it there without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from gubernator_tpu_torch.ops.batch import RequestColumns
from gubernator_tpu_torch.ops.engine import LocalEngine
from gubernator_tpu_torch.ops.slot_write import slot_write, slot_write_ref

pytestmark = pytest.mark.cuda

NOW = 1_700_000_000_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "fl,n,sentinel", [(16, 1 << 17, 0.0), (8, 1 << 17, 0.0), (16, 100_003, 0.1), (16, 1, 0.0)]
)
def test_slot_write_matches_plain_version(card, fl, n, sentinel):
    nb, k = 1 << 18, 8
    gen = torch.Generator(device=card)
    gen.manual_seed(fl * 7 + n)
    base = torch.randint(-(2**31), 2**31 - 1, (nb, k * fl), dtype=torch.int32,
                         device=card, generator=gen)
    payload = torch.randint(-(2**31), 2**31 - 1, (n, fl), dtype=torch.int32,
                            device=card, generator=gen)
    target = torch.randperm(nb * k, device=card, generator=gen)[:n].to(torch.int32)
    drop = torch.rand(n, device=card, generator=gen) < sentinel
    target = torch.where(drop, torch.full_like(target, nb * k), target).contiguous()
    got, want = base.clone(), base.clone()
    before = slot_write.launches
    slot_write(got, payload, target)
    slot_write_ref(want, payload, target)
    torch.cuda.synchronize()
    assert slot_write.launches == before + 1
    assert torch.equal(got, want)


def test_slot_write_rejects_misaligned_payload(card):
    rows = torch.zeros((64, 128), dtype=torch.int32, device=card)
    buf = torch.zeros(16 * 4 + 1, dtype=torch.int32, device=card)
    payload = buf[1:].view(4, 16)  # 4-byte offset: not 16-byte aligned
    target = torch.arange(4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="aligned"):
        slot_write(rows, payload, target)


def test_engine_card_matches_cpu(card):
    """Contended mixed-algorithm batches: responses, stats and table bytes of
    the card's engine equal the CPU engine's."""
    rng = np.random.default_rng(0)
    gpu = LocalEngine(capacity=1 << 14, device=card)
    cpu = LocalEngine(capacity=1 << 14, device="cpu")
    nb = gpu.table.n_buckets
    pool = rng.integers(1, 2**63 - 1, 3_000, dtype=np.int64)
    now = NOW
    launches = slot_write.launches
    for _ in range(4):
        n = 1024
        fp = rng.choice(pool, n)
        hot = rng.random(n) < 0.3
        fp[hot] = rng.integers(1, 1 << 40, hot.sum()) * nb + rng.integers(0, 8, hot.sum())
        cols = RequestColumns(
            fp=fp, algo=rng.integers(0, 5, n).astype(np.int32),
            behavior=(np.where(rng.random(n) < 0.1, 8, 0)
                      | np.where(rng.random(n) < 0.1, 32, 0)).astype(np.int32),
            hits=rng.integers(-1, 5, n).astype(np.int64),
            limit=rng.integers(0, 20, n).astype(np.int64),
            burst=np.zeros(n, np.int64),
            duration=rng.integers(1, 6, n).astype(np.int64) * 1_000,
            created_at=np.zeros(n, np.int64), err=np.zeros(n, np.int8),
        )
        a = gpu.check_columns(cols, now_ms=now)
        b = cpu.check_columns(cols, now_ms=now)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert gpu.snapshot().tobytes() == cpu.snapshot().tobytes()
        now += int(rng.integers(0, 3_000))
    assert dataclasses.asdict(gpu.stats) == dataclasses.asdict(cpu.stats)
    assert slot_write.launches - launches == gpu.stats.dispatches
