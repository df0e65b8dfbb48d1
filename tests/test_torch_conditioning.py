"""Port parity: text conditioning. ByteTokenizer ids and masks are
identical; the `tiny-test` T5 encoder plus projection carries the JAX
conditioner's weights through ckpt/from_jax.py and matches at 1e-4."""

import numpy as np
import pytest
import torch

from jen1_tpu.conditioning import conditioners as jcond
from jen1_tpu.conditioning.t5 import relative_position_bias_index as jax_rp_index
from jen1_tpu.conditioning.tokenizer import ByteTokenizer as JByteTokenizer
from jen1_tpu_torch.conditioning import conditioners as pcond
from jen1_tpu_torch.conditioning.t5 import relative_position_bias_index
from jen1_tpu_torch.conditioning.tokenizer import ByteTokenizer
from torch_port_util import assert_close, load

TEXTS = ["a beautiful song", "", "ab", "ünïcödé ♫ 鼓", "x" * 300]


@pytest.mark.parametrize("max_length", [6, 128])
def test_byte_tokenizer_identical(max_length):
    ids, mask = ByteTokenizer()(TEXTS, max_length)
    jids, jmask = JByteTokenizer()(TEXTS, max_length)
    assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("length", [6, 129])
def test_relative_position_buckets_identical(length):
    np.testing.assert_array_equal(
        relative_position_bias_index(length, length, 32, 128),
        jax_rp_index(length, length, 32, 128),
    )


@pytest.mark.parametrize("max_length", [6, 12])
def test_tiny_t5_conditioner(max_length):
    jc = jcond.T5Conditioner(output_dim=16, t5_model_name="tiny-test", max_length=max_length)
    pc = pcond.T5Conditioner(16, "tiny-test", max_length, device="cpu")
    load(pc, {"encoder": jc.params["encoder"], "proj": jc.params["proj"]})
    texts = TEXTS[:4]
    ref, ref_mask = jc(texts)
    emb, mask = pc(texts)
    assert emb.shape == (4, max_length, 16)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert_close(emb, ref, rtol=1e-4, atol=1e-4)
    assert not emb[2, 3:].any()  # masked positions are zeroed


def test_assemble_conditioning_matches():
    g = np.random.default_rng(0)
    emb = g.standard_normal((2, 6, 16)).astype(np.float32)
    m = np.ones((2, 6), bool)
    x = g.standard_normal((2, 10, 8)).astype(np.float32)
    mk = np.zeros((2, 10, 1), np.float32)
    ref = jcond.assemble_conditioning({"prompt": (emb, m), "masked_input": x, "mask": mk})
    out = pcond.assemble_conditioning({
        "prompt": (torch.from_numpy(emb), torch.from_numpy(m)),
        "masked_input": torch.from_numpy(x), "mask": torch.from_numpy(mk),
    })
    assert set(out) == set(ref)
    for k, v in ref.items():
        if v is None:
            assert out[k] is None
        else:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(v))
