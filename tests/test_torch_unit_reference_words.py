"""convert.from_reference(words=): a list of encrypted write words, or one
stacked array, becomes the int32[B, W, C, L, N] tensor of FheRam.rmw_batch.

One test a file on purpose: with `--dist loadfile` pytest-xdist hands files
out in order of their test count, so single-test files go last; a row of
millisecond files before the suite's longest single test lets it start on
a worker that is really free (ROADMAP.md, "Time budget")."""

import numpy as np
import pytest
import torch

from fhe_ram_tpu_torch.convert import from_reference


def test_from_reference_stacks_write_words():
    rnd = np.random.default_rng(5)
    words = [rnd.integers(-(1 << 16), 1 << 16, size=(4, 2, 3, 16)).astype(np.int32)
             for _ in range(3)]
    got = from_reference(words=words, device="cpu")
    assert got.words.dtype == torch.int32 and got.words.shape == (3, 4, 2, 3, 16)
    assert got.words.device.type == "cpu"
    for k, w in enumerate(words):
        assert np.array_equal(got.words[k].numpy(), w)
    assert torch.equal(from_reference(words=np.stack(words), device="cpu").words,
                       got.words)
    assert got.word is None and got.data is None and got.keys is None
    one = from_reference(word=words[0], device="cpu")
    assert one.words is None and np.array_equal(one.word.numpy(), words[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):   # the default device is the GPU
            from_reference(words=words)
