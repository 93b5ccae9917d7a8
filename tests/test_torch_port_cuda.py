"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA
device.  The file imports no JAX, so on the GPU machine (which has none)
it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import dequant_matmul as tdq
from analytics_zoo_tpu_torch.ops import embedding_bag as teb

RTOL = 1e-5


@pytest.fixture
def cuda_device():
    """The card, built kernels included; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bag_inputs(v, d, b, n, pad_id, seed):
    rs = np.random.RandomState(seed)
    table = rs.randn(v, d).astype(np.float32)
    ids = rs.randint(0, v, size=(b, n)).astype(np.int32)
    if pad_id is not None:
        ids[rs.rand(b, n) < 0.3] = pad_id
        ids[0, :] = pad_id                        # one all-pad bag
    return table, ids



@pytest.mark.cuda
@pytest.mark.parametrize("combiner", teb.COMBINERS)
@pytest.mark.parametrize("pad_id", [0, None])
def test_bag_kernel_matches_plain_on_card(cuda_device, combiner, pad_id):
    table, ids = _bag_inputs(6041, 20, 257, 3, pad_id, seed=1)
    ids[1, 0], ids[2, 1] = -7, 10 ** 6                 # the clip rule
    t = torch.from_numpy(table).to(cuda_device)
    i = torch.from_numpy(ids).to(cuda_device)
    n0 = teb.LAUNCHES.value
    got = teb.embedding_bag(t, i, combiner, pad_id)
    torch.cuda.synchronize()
    assert teb.LAUNCHES.value == n0 + 1
    want = teb.embedding_bag_reference(t, i, combiner, pad_id)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(1, 40, 40), (65, 41, 70)])
def test_dq_kernel_matches_plain_on_card(cuda_device, bits, m, k, n):
    rs = np.random.RandomState(m + k)
    q, s = tdq.quantize_weights(torch.from_numpy(
        rs.randn(k, n).astype(np.float32)), bits=bits)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(cuda_device)
    q, s = q.to(cuda_device), s.to(cuda_device)
    n0 = tdq.LAUNCHES.value
    got = tdq.dequant_matmul(x, q, s, bits=bits, rows=k)
    torch.cuda.synchronize()
    assert tdq.LAUNCHES.value == n0 + 1
    want = tdq.dequant_matmul_reference(x, q, s, bits=bits, rows=k)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-4)


@pytest.mark.cuda
def test_wrappers_raise_for_shapes_the_kernels_cannot_take(cuda_device):
    """A CUDA tensor the kernel cannot take raises; it is never answered
    by the plain version on the card."""
    x = torch.ones(2, 4, device=cuda_device)
    q = torch.ones(3, 4, 5, dtype=torch.int8, device=cuda_device)
    s = torch.ones(5, device=cuda_device)
    n0 = tdq.LAUNCHES.value
    with pytest.raises(ValueError, match=r"dequant_matmul .*\(3, 4, 5\)"):
        tdq.dequant_matmul(x, q, s)
    assert tdq.LAUNCHES.value == n0
    ids = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match=r"embedding_bag .*\(0, 4\)"):
        teb.embedding_bag(torch.ones(0, 4, device=cuda_device), ids)


@pytest.mark.cuda
@pytest.mark.parametrize("weight_dtype", ["float32", "int8", "int4"])
def test_ncf_serving_on_card_matches_cpu(cuda_device, weight_dtype):
    """NeuralCF served on the card (through both kernels) answers as the
    same weights served on the CPU (through the plain versions)."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF

    ncf = NeuralCF(200, 150, user_embed=16, item_embed=16, mf_embed=16,
                   hidden_layers=(64, 16), device="cpu")
    rs = np.random.RandomState(0)
    params = {layer: {leaf: (rs.randn(*v.shape) * 0.5).astype(np.float32)
                      for leaf, v in sub.items()}
              for layer, sub in ncf.model.params().items()}
    u = rs.randint(1, 201, (70, 1)).astype(np.int32)
    i = rs.randint(1, 151, (70, 1)).astype(np.int32)
    cpu = InferenceModel.from_keras_net(ncf.model, params, device="cpu",
                                        weight_dtype=weight_dtype)
    card = InferenceModel.from_keras_net(ncf.model, params,
                                         device=cuda_device,
                                         weight_dtype=weight_dtype)
    b0, d0 = teb.LAUNCHES.value, tdq.LAUNCHES.value
    got = card.predict([u, i])
    # 70 rows pad to the 256-row bucket: one forward, four tables, and
    # two Dense kernels (32x64, 64x16) at quantize_pytree's 1024 floor
    assert teb.LAUNCHES.value - b0 == 4
    assert tdq.LAUNCHES.value - d0 == (0 if weight_dtype == "float32"
                                       else 2)
    np.testing.assert_allclose(got, cpu.predict([u, i]), rtol=0, atol=1e-5)
