"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA card; on a host without one every test here skips. This file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(--noconftest: tests/conftest.py configures JAX.)
"""

import pytest
import torch

from flatquant_torch.kernels import common
from flatquant_torch.kernels import int4_matmul as tmm
from flatquant_torch.kernels import kv_cache as tkv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain GEMM is exact
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(1, 4096, 4096), (8, 1024, 11008),
                                   (40, 384, 512)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_w4a4_matmul_i8_bit_exact(cuda, m, n, k, out):
    g = torch.Generator(device=cuda).manual_seed(m)
    xq = torch.randint(-8, 8, (m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    xs = torch.rand((m, 1), generator=g, device=cuda) + 0.01
    wp = torch.randint(0, 256, (n, k // 2), generator=g, device=cuda,
                       dtype=torch.uint8)
    sw = torch.rand((n,), generator=g, device=cuda) * 0.05
    before = common.LAUNCHES["w4a4_matmul_i8"]
    got = tmm.w4a4_matmul_i8(xq, xs, wp, sw, out)
    assert common.LAUNCHES["w4a4_matmul_i8"] == before + 1
    assert torch.equal(got, tmm.w4a8_matmul_ref(xq, xs, wp, sw, out))


def _cache(g, cuda, B, nkv, S):
    u8 = dict(generator=g, device=cuda, dtype=torch.uint8)
    kp = torch.randint(0, 256, (B, nkv, S, 64), **u8)
    vp = torch.randint(0, 256, (B, nkv, S, 64), **u8)
    kpar = torch.rand((B, nkv, S, 2), generator=g, device=cuda)
    vpar = torch.rand((B, nkv, S, 2), generator=g, device=cuda)
    return kp, kpar, vp, vpar


@pytest.mark.gpu
@pytest.mark.parametrize("nh,nkv", [(8, 8), (8, 2)])
def test_decode_attention_int4_matches_plain(cuda, nh, nkv):
    g = torch.Generator(device=cuda).manual_seed(nkv)
    B, S = 3, 512
    kp, kpar, vp, vpar = _cache(g, cuda, B, nkv, S)
    q = torch.randn((B, nh, 128), generator=g, device=cuda)
    valid = torch.tensor([0, 200, 512], device=cuda, dtype=torch.int32)
    got = tkv.decode_attention_int4(q, kp, kpar, vp, vpar, valid, 0.088)
    want = tkv.decode_attention_ref(q, kp, kpar[..., :1], kpar[..., 1:], vp,
                                    vpar[..., :1], vpar[..., 1:], valid,
                                    0.088)
    # float32 outputs: scale/zero folded into the epilogues and another
    # summation order than the plain version
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert bool((got[0] == 0).all())


@pytest.mark.gpu
def test_write_token_bit_exact_in_place(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    caches = list(_cache(g, cuda, 3, 2, 512))
    copies = [c.clone() for c in caches]
    new = [c[:, :, :1].clone() for c in _cache(g, cuda, 3, 2, 1)]
    pos = torch.tensor([5, 511, 1000], device=cuda, dtype=torch.int32)
    ptrs = [c.data_ptr() for c in caches]
    out = tkv.write_token(*caches, *new, pos)
    tkv.write_token_ref(*copies, *new, pos)
    assert [c.data_ptr() for c in out] == ptrs
    for a, b in zip(caches, copies):
        assert torch.equal(a, b)
