"""Port flash attention (plain version of the CUDA kernel) vs the JAX Pallas
kernel in interpret mode: ragged Sq/Sk including S = 2, head dims 64 and 128
(VGGT) and 32 and 16 (SAM's mask decoder: 11 prompt tokens against image
tokens and back), f32, atol 1e-5. Also the kernel wrapper's refusals on the
CPU side."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.ops.attention import flash_attention as jax_flash
from regen3d_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
    flash_attention_fwd,
)
from test_torch_package import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("sq,sk,d", [(37, 37, 64), (40, 37, 128), (2, 2, 128),
                                     (5, 2, 64), (11, 11, 32), (11, 70, 16),
                                     (70, 11, 16)])
def test_flash_attention_matches_pallas(sq, sk, d):
    rng = np.random.default_rng(sq * 100 + sk + d)
    q = rng.normal(size=(2, 3, sq, d)).astype(np.float32)
    k = rng.normal(size=(2, 3, sk, d)).astype(np.float32)
    v = rng.normal(size=(2, 3, sk, d)).astype(np.float32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_lse_is_the_row_logsumexp():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 9, 64)).astype(np.float32))
               for _ in range(3))
    o, lse = flash_attention_fwd(q, k, v, scale=0.3)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    torch.testing.assert_close(o, torch.softmax(logits, -1) @ v)
    torch.testing.assert_close(attention_reference(q, k, v, 0.3)[0], o)


def test_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros(1, 2, 4, 32), torch.zeros(1, 2, 4, 32))
