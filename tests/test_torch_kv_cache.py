"""Port parity: the paged KV cache writers and the page allocator of
cuda_flash_attention_tpu_torch against the JAX package's, on the same numpy
inputs.  int8 quantization must agree bit for bit (values) and exactly
(scales); so must every page tensor after a prompt write and three decode
appends."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu_torch.decode import kv_cache

PAGE = 128
DTYPES = [
    (jnp.int8, torch.int8),
    (jnp.bfloat16, torch.bfloat16),
    (jnp.float32, torch.float32),
]


def _np(x):
    """A JAX or torch array as a numpy array (bf16 through fp32, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.0])
def test_quantize_rows_int8_bit_exact(scale):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((7, 3, 64)) * scale).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row takes the 1e-12 scale floor
    vj, sj = jax_kv._quantize_rows(jnp.asarray(x), jnp.int8)
    vt, st = kv_cache._quantize_rows(torch.from_numpy(x), torch.int8)
    assert vt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_rows_int8_from_bf16_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 2, 64)).astype(np.float32)
    vj, sj = jax_kv._quantize_rows(jnp.asarray(x, jnp.bfloat16), jnp.int8)
    vt, st = kv_cache._quantize_rows(
        torch.from_numpy(x).to(torch.bfloat16), torch.int8)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["int8", "bf16", "fp32"])
def test_prompt_write_and_appends_match_jax(jdt, tdt):
    hkv, d, num_pages = 2, 64, 6
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2 * PAGE, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2 * PAGE, hkv, d)).astype(np.float32)
    ids = np.array([4, 2], np.int32)
    pj = jax_kv.write_prompt_kv(
        jax_kv.init_kv_pages(hkv, num_pages, PAGE, d, jdt),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids))
    pt = kv_cache.write_prompt_kv(
        kv_cache.init_kv_pages(hkv, num_pages, PAGE, d, tdt, device="cpu"),
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ids))

    # Three slots; slot 1 is inactive (writes the null page 0).  Slot 0's
    # appends cross from page 4 into page 2 at position PAGE.
    table = np.array([[4, 2, 0], [0, 0, 0], [1, 3, 0]], np.int32)
    active = np.array([True, False, True])
    for step in range(3):
        positions = np.array([PAGE - 1 + step, 0, 5 + step], np.int32)
        kn = rng.standard_normal((3, hkv, d)).astype(np.float32)
        vn = rng.standard_normal((3, hkv, d)).astype(np.float32)
        pj = jax_kv.append_token_kv(
            pj, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table),
            jnp.asarray(positions), jnp.asarray(active))
        pt = kv_cache.append_token_kv(
            pt, torch.from_numpy(kn), torch.from_numpy(vn),
            torch.from_numpy(table), torch.from_numpy(positions).long(),
            torch.from_numpy(active))
    for name in ("k_pages", "k_scales", "v_pages", "v_scales"):
        np.testing.assert_array_equal(_np(getattr(pt, name)),
                                      _np(getattr(pj, name)), err_msg=name)


def test_writes_are_in_place():
    pages = kv_cache.init_kv_pages(1, 3, PAGE, 64, torch.int8, device="cpu")
    k_before = pages.k_pages
    out = kv_cache.append_token_kv(
        pages, torch.ones(1, 1, 64), torch.ones(1, 1, 64),
        torch.tensor([[2]], dtype=torch.int32), torch.tensor([3]),
        torch.tensor([True]))
    assert out.k_pages is k_before
    assert k_before[0, 2, 3].eq(127).all()


def test_page_allocator_hands_out_the_same_ids():
    aj, at = jax_kv.PageAllocator(12), kv_cache.PageAllocator(12)
    held_j, held_t = [], []
    for n in (3, 2, 4):
        held_j.append(aj.alloc(n))
        held_t.append(at.alloc(n))
    for i in (0, 2):
        aj.free(held_j[i])
        at.free(held_t[i])
    for n in (1, 5):
        held_j.append(aj.alloc(n))
        held_t.append(at.alloc(n))
    assert held_t == held_j
    assert at.available == aj.available
    with pytest.raises(MemoryError):
        at.alloc(at.available + 1)


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fnuz, torch.float16])
def test_unported_cache_dtypes_raise(dtype):
    with pytest.raises(NotImplementedError):
        kv_cache.init_kv_pages(1, 2, PAGE, 64, dtype, device="cpu")
