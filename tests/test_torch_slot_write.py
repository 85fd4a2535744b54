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
from gubernator_tpu_torch.ops.layout import LAYOUTS as TLAYOUTS
from gubernator_tpu_torch.ops.slot_write import slot_write, slot_write_ref

# the tensors here are tiny: one intra-op thread keeps parallel test workers
# from oversubscribing the CPU
torch.set_num_threads(1)

K = 8
# the layout a slot width stands for in the numpy cases
LAYOUT_OF = {16: "full", 8: "gcra32"}


def _i32(rng, shape):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def _case(nb, fl, n, seed, sentinel_frac=0.2):
    """Table rows, canonical rows and a claim: unique slots, some rows not
    written (the claim's sentinels)."""
    rng = np.random.default_rng(seed)
    rows = _i32(rng, (nb, K * fl))
    new16 = _i32(rng, (n, 16))
    slots = rng.permutation(nb * K)[:n]
    written = rng.random(n) >= sentinel_frac
    return rows, new16, written, (slots // K).astype(np.int32), (slots % K).astype(np.int64)


def _tensors(new16, written, bucket, chosen):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (new16, written, bucket, chosen)]


def _numpy_pack(new16, layout):
    """The layouts' field order (ops/layout.py), written out in numpy."""
    if layout == "full":
        return new16
    f = new16.astype(np.int64)
    meta = (f[:, 7] & 0x7FFFFF) | (((f[:, 5] >> 8) & 0xFF) << 23)
    cols = {"gcra32": [f[:, 0], f[:, 1], f[:, 13], f[:, 12], f[:, 2], f[:, 3], f[:, 6], meta],
            "token32": [f[:, 0], f[:, 1], f[:, 4], f[:, 2], f[:, 10], f[:, 11], f[:, 6],
                        meta]}[layout]
    return (np.stack(cols, axis=1) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _numpy_ref(rows, new16, written, bucket, chosen, layout):
    fl = 16 if layout == "full" else 8
    out = rows.copy().reshape(-1, fl)
    target = bucket.astype(np.int64) * K + chosen
    keep = written & (target < out.shape[0])
    out[target[keep]] = _numpy_pack(new16, layout)[keep]
    return out.reshape(rows.shape)


@pytest.mark.parametrize("fl", [16, 8])
@pytest.mark.parametrize("n", [1, 17, 64, 300])
def test_cpu_path_matches_numpy(fl, n):
    rows, *claim = _case(64, fl, n, seed=n + fl)
    t = torch.from_numpy(rows.copy())
    before = slot_write.launches
    out = slot_write(t, *_tensors(*claim), LAYOUT_OF[fl])
    assert out is t  # in place
    np.testing.assert_array_equal(t.numpy(), _numpy_ref(rows, *claim, LAYOUT_OF[fl]))
    assert slot_write.launches == before  # the plain version is no launch


@pytest.mark.parametrize("n", [1, 17, 300])
def test_cpu_path_matches_numpy_token32(n):
    rows, *claim = _case(64, 8, n, seed=n)
    t = torch.from_numpy(rows.copy())
    slot_write(t, *_tensors(*claim), TLAYOUTS["token32"])
    np.testing.assert_array_equal(t.numpy(), _numpy_ref(rows, *claim, "token32"))


def _jax_write_xla(rows, new16, written, bucket, chosen, layout):
    lay = JLAYOUTS[layout]
    claim = SimpleNamespace(written=jnp.asarray(written), bucket=jnp.asarray(bucket),
                            chosen=jnp.asarray(chosen.astype(np.int32)))
    return np.asarray(jk._write_xla(jnp.asarray(rows), jnp.asarray(new16), claim, lay))


@pytest.mark.parametrize("layout", ["full", "gcra32", "token32"])
def test_cpu_path_matches_jax_write_xla(layout):
    """The JAX scatter write over a claim (written, bucket, chosen) lands the
    same bytes as slot_write on the same claim, at a ragged batch with
    sentinel rows."""
    lay = JLAYOUTS[layout]
    rows, new16, written, bucket, chosen = _case(32, lay.F, 45, seed=5)
    want = _jax_write_xla(rows, new16, written, bucket, chosen, layout)
    got = torch.from_numpy(rows.copy())
    slot_write(got, *_tensors(new16, written, bucket, chosen), layout)
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("layout", ["full", "gcra32", "token32"])
@pytest.mark.parametrize("case", ["none_written", "one_row", "flags_high"])
def test_cpu_path_matches_jax_write_xla_edges(layout, case):
    """Edges of the same comparison: no row written, a batch of one, and
    canonical rows with every bit of dur_hi and of the status byte set
    (meta's top bits)."""
    lay = JLAYOUTS[layout]
    n = 1 if case == "one_row" else 33
    rows, new16, written, bucket, chosen = _case(16, lay.F, n, seed=len(case), sentinel_frac=0.0)
    if case == "none_written":
        written[:] = False
    if case == "flags_high":
        new16[:, 5] = (np.arange(n, dtype=np.int32) % 2 * 0xFF) << 8 | 2
        new16[:, 7] = -1
    want = _jax_write_xla(rows, new16, written, bucket, chosen, layout)
    got = torch.from_numpy(rows.copy())
    slot_write(got, *_tensors(new16, written, bucket, chosen), layout)
    assert got.numpy().tobytes() == want.tobytes()
    if case == "none_written":
        assert want.tobytes() == rows.tobytes()


def test_ref_skips_every_sentinel():
    rows, new16, written, bucket, chosen = _case(16, 16, 40, seed=3, sentinel_frac=1.0)
    t = torch.from_numpy(rows.copy())
    slot_write_ref(t, *_tensors(new16, written, bucket, chosen), "full")
    assert t.numpy().tobytes() == rows.tobytes()


def test_write_claim_is_one_slot_write_call(monkeypatch):
    """The engine's write hands the claim and the canonical rows to one
    slot_write call, which packs and forms the targets itself."""
    from gubernator_tpu_torch.ops import kernel2
    from gubernator_tpu_torch.ops.table2 import Table2

    rows, new16, written, bucket, chosen = _case(8, 8, 20, seed=9)
    calls = []
    monkeypatch.setattr(kernel2, "slot_write",
                        lambda *a: calls.append(a) or slot_write_ref(*a))
    table = Table2(torch.from_numpy(rows.copy()), TLAYOUTS["token32"])
    w, b, c = (torch.from_numpy(a) for a in (written, bucket, chosen))
    claim = SimpleNamespace(written=w, bucket=b, chosen=c)
    kernel2._write_claim(table, torch.from_numpy(new16), claim)
    assert len(calls) == 1 and calls[0][-1] is TLAYOUTS["token32"]
    np.testing.assert_array_equal(table.rows.numpy(),
                                  _numpy_ref(rows, new16, written, bucket, chosen, "token32"))


@pytest.mark.parametrize(
    "mutate",
    [
        lambda r, n, w, b, c: (r.to(torch.int64), n, w, b, c),
        lambda r, n, w, b, c: (r, n.to(torch.float32), w, b, c),
        lambda r, n, w, b, c: (r, n, w, b.to(torch.int64), c),
        lambda r, n, w, b, c: (r, n[:, :8].contiguous(), w, b, c),
        lambda r, n, w, b, c: (r, n[:-1], w, b, c),
        lambda r, n, w, b, c: (r, n.t().contiguous().t(), w, b, c),
        lambda r, n, w, b, c: (r.t(), n, w, b, c),
        lambda r, n, w, b, c: (r, n, w[:, None], b, c),
        lambda r, n, w, b, c: (r, n, w.to(torch.int32), b, c),
        lambda r, n, w, b, c: (r, n, w, b, c.to(torch.int32)),
        lambda r, n, w, b, c: (r, n, w, b, c[:-1]),
        lambda r, n, w, b, c: (r.view(-1)[:-4], n, w, b, c),
    ],
)
def test_rejects_bad_operands(mutate):
    rows, *claim = _case(8, 16, 8, seed=0)
    args = mutate(torch.from_numpy(rows), *_tensors(*claim))
    with pytest.raises((TypeError, ValueError)):
        slot_write(*args, "full")


def test_rejects_unknown_layout():
    rows, *claim = _case(8, 16, 8, seed=0)
    with pytest.raises((KeyError, ValueError)):
        slot_write(torch.from_numpy(rows), *_tensors(*claim), "full64")


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
