"""The port's paged KV cache, cached attention and LoRA bank helpers
against the JAX package on the CPU.

The cache arithmetic (``gather_view``, the three scatters,
``copy_block_rows``) is integer indexing and copies, so it must agree
exactly; so must the host bookkeeping (``BlockAllocator``,
``PrefixIndex``) after the same sequence of operations, and
``lora_stack``/``lora_select``. ``cached_attention`` agrees within the
house float32 tolerance. Inputs are seeded numpy arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.llm import attention as jattn
from fedml_tpu.llm import kv_cache as jkv
from fedml_tpu.llm import lora as jlora
from fedml_tpu_torch.llm import attention as tattn
from fedml_tpu_torch.llm import kv_cache as tkv
from fedml_tpu_torch.llm import lora as tlora

from torch_port_support import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 2e-4, 2e-5
# the tiny serving geometry: 2 layers, 2 heads of 16, seq 64, blocks of 16
CFG = dict(num_layers=2, kv_heads=2, head_dim=16, max_seq_len=64,
           block_size=16, num_blocks=12)


def _cfgs():
    return jkv.KVCacheConfig(**CFG), tkv.KVCacheConfig(**CFG)


def _pools(seed):
    """Random K and V pools (the trash block included), numpy f32."""
    rs = np.random.RandomState(seed)
    c = CFG
    shape = (c["num_layers"], c["num_blocks"] + 1, c["block_size"],
             c["kv_heads"], c["head_dim"])
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _tables():
    """Three slots' tables: a full row, a partial row (trash tail) and an
    all-trash row (an inactive slot)."""
    t = CFG["num_blocks"]
    return np.array([[0, 5, 3, 7], [2, 9, t, t], [t, t, t, t]], np.int32)


def _without_trash(pool):
    """Every block but the trash block: several dropped rows may land on
    one trash row, and which one wins is undefined in both frameworks."""
    return np.asarray(pool)[:, :CFG["num_blocks"]]


def test_config_and_pools():
    jc, tc = _cfgs()
    assert (tc.max_blocks_per_slot, tc.trash_block, tc.blocks_needed(17)) \
        == (jc.max_blocks_per_slot, jc.trash_block, jc.blocks_needed(17))
    with pytest.raises(ValueError, match="divide"):
        tkv.KVCacheConfig(2, 2, 16, max_seq_len=60, block_size=16)
    jk, _ = jkv.init_pools(jc, jnp.bfloat16)
    tk, tv = tkv.init_pools(tc, torch.bfloat16)
    assert tuple(tk.shape) == jk.shape and tk.dtype == torch.bfloat16
    assert not tk.any() and not tv.any()


@pytest.mark.parametrize("rows", ["batch", "one_row"])
def test_gather_view_exact(rows):
    kp, _ = _pools(0)
    tables = _tables() if rows == "batch" else _tables()[1]
    want = np.asarray(jkv.gather_view(jnp.asarray(kp[1]),
                                      jnp.asarray(tables)))
    got = tkv.gather_view(torch.from_numpy(kp[1]), torch.from_numpy(tables))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_token_exact():
    """Two active slots and one inactive (routed to the trash block), with
    positions past the table clipped as in the JAX function."""
    jc, _ = _cfgs()
    kp, _ = _pools(1)
    tables = _tables()
    pos = np.array([37, 20, 63], np.int32)
    active = np.array([True, True, False])
    vals = np.random.RandomState(2).randn(3, 2, 16).astype(np.float32)
    for layer in (0, 1):
        want = jkv.scatter_token(jnp.asarray(kp), layer, jnp.asarray(tables),
                                 jnp.asarray(pos), jnp.asarray(vals),
                                 jnp.asarray(active), jc.block_size,
                                 jc.trash_block)
        got = tkv.scatter_token(torch.from_numpy(kp.copy()), layer,
                                torch.from_numpy(tables),
                                torch.from_numpy(pos),
                                torch.from_numpy(vals),
                                torch.from_numpy(active), jc.block_size,
                                jc.trash_block)
        np.testing.assert_array_equal(_without_trash(got),
                                      _without_trash(want))


def test_scatter_chunk_exact_with_padded_tail():
    jc, _ = _cfgs()
    _, vp = _pools(3)
    row = _tables()[0]
    positions = np.arange(14, 14 + 8, dtype=np.int32)
    valid = np.arange(8) < 5          # a padded chunk tail
    vals = np.random.RandomState(4).randn(8, 2, 16).astype(np.float32)
    want = jkv.scatter_chunk(jnp.asarray(vp), 1, jnp.asarray(row),
                             jnp.asarray(positions), jnp.asarray(vals),
                             jnp.asarray(valid), jc.block_size,
                             jc.trash_block)
    got = tkv.scatter_chunk(torch.from_numpy(vp.copy()), 1,
                            torch.from_numpy(row),
                            torch.from_numpy(positions),
                            torch.from_numpy(vals), torch.from_numpy(valid),
                            jc.block_size, jc.trash_block)
    np.testing.assert_array_equal(_without_trash(got), _without_trash(want))


def test_scatter_chunk_batch_exact_with_empty_row():
    jc, _ = _cfgs()
    kp, _ = _pools(5)
    rows = _tables()
    p0 = np.array([30, 4, 0], np.int32)
    positions = p0[:, None] + np.arange(8, dtype=np.int32)[None, :]
    valid = np.arange(8)[None, :] < np.array([8, 3, 0])[:, None]
    vals = np.random.RandomState(6).randn(3, 8, 2, 16).astype(np.float32)
    want = jkv.scatter_chunk_batch(jnp.asarray(kp), 0, jnp.asarray(rows),
                                   jnp.asarray(positions), jnp.asarray(vals),
                                   jnp.asarray(valid), jc.block_size,
                                   jc.trash_block)
    got = tkv.scatter_chunk_batch(torch.from_numpy(kp.copy()), 0,
                                  torch.from_numpy(rows),
                                  torch.from_numpy(positions),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(valid), jc.block_size,
                                  jc.trash_block)
    np.testing.assert_array_equal(_without_trash(got), _without_trash(want))


@pytest.mark.parametrize("n_rows", [0, 5, 16])
def test_copy_block_rows_exact(n_rows):
    kp, _ = _pools(7)
    want = jkv.copy_block_rows(jnp.asarray(kp), 3, 8, n_rows)
    got = tkv.copy_block_rows(torch.from_numpy(kp.copy()), 3, 8, n_rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _allocator_state(alloc):
    return (list(alloc._free), {k: list(v) for k, v in alloc._owned.items()},
            dict(alloc._refs))


def _index_state(index):
    return (dict(index._entries), {k: dict(v) for k, v in index._meta.items()},
            index.debug_state())


def test_allocator_and_prefix_index_state_match():
    """The same alloc / retain / release / insert / match / evict sequence
    leaves both packages' host bookkeeping in the same state."""
    states = []
    for kv in (jkv, tkv):
        cfg = kv.KVCacheConfig(**CFG)
        alloc, index = kv.BlockAllocator(cfg), kv.PrefixIndex(16)
        ids_a = list(range(1, 41))                # 2 full blocks + 8
        ids_b = list(range(1, 33)) + [99] * 5     # shares 2 blocks with a
        row_a = alloc.alloc(0, len(ids_a) + 8)
        index.insert(ids_a, row_a, len(ids_a), alloc)
        chain = index.match(ids_b)
        row_b = alloc.alloc(1, len(ids_b) + 4, shared=chain)
        index.insert(ids_b, row_b, len(ids_b), alloc, origin="decode")
        alloc.retain(int(row_b[2]))
        alloc.release_block(int(row_b[2]))
        alloc.free(0)
        row_c = alloc.alloc(2, 30)
        index.insert([7] * 30, row_c, 30, alloc)
        index.match([7] * 20)
        freed = index.evict(alloc, need_free=alloc.free_blocks + 2,
                            protect=chain[:1])
        states.append((row_a.tolist(), row_b.tolist(), row_c.tolist(),
                       chain, freed, index.count_suffix_reuse(chain),
                       index.reclaimable(alloc), alloc.aliased_blocks(),
                       _allocator_state(alloc), _index_state(index)))
    assert states[0] == states[1]


def test_allocator_refusals():
    cfg = tkv.KVCacheConfig(**CFG)
    alloc = tkv.BlockAllocator(cfg)
    alloc.alloc(0, 64)
    with pytest.raises(RuntimeError, match="already holds"):
        alloc.alloc(0, 16)
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.alloc(1, 64 * 4)
    with pytest.raises(RuntimeError, match="over-freed"):
        alloc.release_block(0)   # still on the free list


def test_lora_stack_select_exact():
    rs = np.random.RandomState(8)
    shapes = {"layer_0.attn.q.lora_a": (32, 4), "layer_0.attn.q.lora_b":
              (4, 32), "layer_0.mlp.up.lora_a": (32, 4),
              "layer_0.mlp.up.lora_b": (4, 64)}
    adapters = [{k: rs.randn(*s).astype(np.float32)
                 for k, s in shapes.items()} for _ in range(3)]
    nested = [{"layer_0": {"attn": {"q": {"lora_a": a["layer_0.attn.q.lora_a"],
                                          "lora_b": a["layer_0.attn.q.lora_b"]}},
                           "mlp": {"up": {"lora_a": a["layer_0.mlp.up.lora_a"],
                                          "lora_b": a["layer_0.mlp.up.lora_b"]}}}}
              for a in adapters]
    jstack = jlora.lora_stack(nested)
    tstack = tlora.lora_stack([{k: torch.from_numpy(v) for k, v in a.items()}
                               for a in adapters])
    idx = np.array([2, 0, 2, 1], np.int32)
    jsel = jlora.lora_select(jstack, jnp.asarray(idx))
    tsel = tlora.lora_select(tstack, torch.from_numpy(idx).long())
    one = tlora.lora_select(tstack, 1)
    for key in shapes:
        path = key.split(".")
        node_s, node_1 = jsel, jlora.lora_select(jstack, 1)
        for p in path:
            node_s, node_1 = node_s[p], node_1[p]
        np.testing.assert_array_equal(tsel[key].numpy(), np.asarray(node_s))
        np.testing.assert_array_equal(one[key].numpy(), np.asarray(node_1))
    with pytest.raises(ValueError):
        tlora.lora_stack([])


@pytest.mark.parametrize("s", [1, 6])
def test_cached_attention_matches(s):
    """Decode (s 1) and a prefill chunk (s 6) over a 64-key view, with one
    row at the sentinel position (sees every key) and one early row."""
    rs = np.random.RandomState(9 + s)
    b, t, h, d = 3, 64, 2, 16
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, t, h, d).astype(np.float32)
    v = rs.randn(b, t, h, d).astype(np.float32)
    qpos = np.array([[40 + i for i in range(s)], [i for i in range(s)],
                     [64] * s], np.int32)
    want = jattn.cached_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(qpos))
    got = tattn.cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
