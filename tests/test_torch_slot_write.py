"""The slot-write kernel module (gubernator_tpu_torch.ops.slot_write).

On the CPU the wrapper takes the plain version, which must equal the JAX
package's ``_write_xla`` scatter (the function the TPU's sweep and sparse
kernels also compute) on the same claim, byte for byte. The CUDA kernel
itself runs only on the card: tests/test_torch_cuda.py holds it against the
plain version there.
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import kernel2 as jk
from gubernator_tpu.ops.layout import LAYOUTS as JLAYOUTS
from gubernator_tpu_torch import _build
from gubernator_tpu_torch.ops.slot_write import slot_write, slot_write_ref

# the tensors here are tiny: one intra-op thread keeps parallel test workers
# from oversubscribing the CPU
torch.set_num_threads(1)

K = 8


def _case(nb, fl, n, seed, sentinel_frac=0.2):
    """Table rows, payload and targets: unique targets, some sentinels."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-(2**31), 2**31, (nb, K * fl), dtype=np.int64).astype(np.int32)
    payload = rng.integers(-(2**31), 2**31, (n, fl), dtype=np.int64).astype(np.int32)
    target = rng.permutation(nb * K)[:n].astype(np.int32)
    target[rng.random(n) < sentinel_frac] = nb * K
    return rows, payload, target


def _numpy_ref(rows, payload, target, fl):
    out = rows.copy().reshape(-1, fl)
    keep = target < out.shape[0]
    out[target[keep]] = payload[keep]
    return out.reshape(rows.shape)


@pytest.mark.parametrize("fl", [16, 8])
@pytest.mark.parametrize("n", [1, 17, 64, 300])
def test_cpu_path_matches_numpy(fl, n):
    rows, payload, target = _case(64, fl, n, seed=n + fl)
    t = torch.from_numpy(rows.copy())
    before = slot_write.launches
    out = slot_write(t, torch.from_numpy(payload), torch.from_numpy(target))
    assert out is t  # in place
    np.testing.assert_array_equal(t.numpy(), _numpy_ref(rows, payload, target, fl))
    assert slot_write.launches == before  # the plain version is no launch


@pytest.mark.parametrize("layout", ["full", "gcra32"])
def test_cpu_path_matches_jax_write_xla(layout):
    """The JAX scatter write over a claim (written, bucket, chosen) lands the
    same bytes as slot_write on the equivalent targets."""
    lay = JLAYOUTS[layout]
    nb, n = 32, 48
    rng = np.random.default_rng(5)
    rows, _, _ = _case(nb, lay.F, 1, seed=1)
    slots = rng.permutation(nb * K)[:n]
    new16 = rng.integers(-(2**31), 2**31, (n, 16), dtype=np.int64).astype(np.int32)
    written = rng.random(n) < 0.8
    claim = SimpleNamespace(
        written=jnp.asarray(written),
        bucket=jnp.asarray((slots // K).astype(np.int32)),
        chosen=jnp.asarray((slots % K).astype(np.int32)),
    )
    want = np.asarray(jk._write_xla(jnp.asarray(rows), jnp.asarray(new16), claim, lay))
    target = np.where(written, slots, nb * K).astype(np.int32)
    got = torch.from_numpy(rows.copy())
    slot_write(got, torch.from_numpy(np.ascontiguousarray(lay.pack(new16))),
               torch.from_numpy(target))
    assert got.numpy().tobytes() == want.tobytes()


def test_ref_skips_every_sentinel():
    rows, payload, target = _case(16, 16, 40, seed=3, sentinel_frac=1.0)
    t = torch.from_numpy(rows.copy())
    slot_write_ref(t, torch.from_numpy(payload), torch.from_numpy(target))
    assert t.numpy().tobytes() == rows.tobytes()


@pytest.mark.parametrize(
    "mutate",
    [
        lambda r, p, t: (r.to(torch.int64), p, t),
        lambda r, p, t: (r, p.to(torch.float32), t),
        lambda r, p, t: (r, p, t.to(torch.int64)),
        lambda r, p, t: (r, p[:, :6].contiguous(), t),
        lambda r, p, t: (r, p[:-1], t),
        lambda r, p, t: (r, p.t().contiguous().t(), t),
        lambda r, p, t: (r.t(), p, t),
        lambda r, p, t: (r, p, t[:, None]),
    ],
)
def test_rejects_bad_operands(mutate):
    rows, payload, target = _case(8, 16, 8, seed=0)
    r, p, t = mutate(torch.from_numpy(rows), torch.from_numpy(payload),
                     torch.from_numpy(target))
    with pytest.raises((TypeError, ValueError)):
        slot_write(r, p, t)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises instead of falling back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_build_lists_every_included_header(name):
    """A kernel's library is named after the hash of its source and its
    listed headers, so a header it includes (directly or through another
    header) but does not list would leave a stale build loaded after an
    edit."""
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        text = (_build.CSRC / todo.pop()).read_text()
        for h in re.findall(r'^#include "([^"]+)"', text, re.M):
            if h not in seen:
                seen.add(h)
                todo.append(h)
    assert sorted(seen) == sorted(_build.KERNELS[name]["headers"])


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert (_build.CSRC / "slot_write.cu").is_file()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
