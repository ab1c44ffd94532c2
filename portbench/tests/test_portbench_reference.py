"""The reference's GF(2^8) arithmetic and encode, held to fixed vectors
and to an independent bitwise multiply; the port agrees with it."""
import numpy as np
import pytest
import torch

from portbench import reference as ref


def slow_mul(a: int, b: int) -> int:
    """Shift-and-add multiply modulo 0x11d."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
        b >>= 1
    return out


def test_mul_fixed_vectors():
    assert [ref.mul(a, b) for a, b in ((2, 0x80), (0x53, 0xCA), (0xFF, 0xFF),
                                       (3, 7), (0x8E, 2), (0, 9), (1, 0xAB))] \
        == [29, 143, 226, 9, 1, 0, 0xAB]


def test_mul_and_inverse_over_the_field():
    for a in range(256):
        for b in range(0, 256, 7):
            assert ref.mul(a, b) == slow_mul(a, b)
        if a:
            assert ref.mul(a, ref.inv(a)) == 1


def test_generator_fixed_vectors():
    gen = ref.generator(9, 6)
    assert gen[:6] == tuple(tuple(int(i == j) for j in range(6)) for i in range(6))
    assert gen[6:] == ((186, 105, 211, 210, 104, 187),
                       (254, 96, 137, 96, 247, 129),
                       (86, 58, 123, 147, 172, 41))


def test_encode_fixed_vector():
    data = torch.tensor([[(7 * i + 13 * j) % 256 for i in range(8)]
                         for j in range(6)], dtype=torch.uint8)
    parity = [p.tolist() for p in ref.encode_parity(9, 6, data)]
    assert parity == [[144, 93, 123, 162, 251, 22, 142, 177],
                      [205, 152, 84, 19, 220, 177, 24, 241],
                      [187, 87, 225, 206, 60, 147, 80, 34]]


@pytest.mark.parametrize("n,k", [(9, 6), (14, 10)])
def test_any_k_blocks_restore_a_lost_one(n, k):
    rng = np.random.default_rng(n)
    data = torch.from_numpy(rng.integers(0, 256, (k, 1000), dtype=np.uint8))
    cw = list(data) + ref.encode_parity(n, k, data)
    for lost in range(n):
        helpers = sorted(rng.choice([i for i in range(n) if i != lost], k,
                                    replace=False).tolist())
        got = ref.combine(ref.repair_coeffs(n, k, lost, helpers),
                          [cw[h] for h in helpers])
        assert ref.bytes_differing(got, cw[lost]) == 0


def test_chunked_combine(monkeypatch):
    monkeypatch.setattr(ref, "CHUNK", 64)
    data = torch.arange(6 * 300, dtype=torch.int64).remainder(251).to(torch.uint8).view(6, 300)
    whole = [list(map(int, p)) for p in ref.encode_parity(9, 6, data)]
    for row, par in zip(ref.generator(9, 6)[6:], whole):
        want = [0] * 300
        for c, d in zip(row, data.tolist()):
            want = [w ^ slow_mul(c, x) for w, x in zip(want, d)]
        assert par == want


def test_bytes_differing():
    a = torch.zeros(100, dtype=torch.uint8)
    b = a.clone()
    b[[3, 50, 99]] = 1
    assert ref.bytes_differing(a, b) == 3
    assert ref.bytes_differing(a, a[:10]) == 100


@pytest.mark.parametrize("n,k", [(9, 6), (14, 10)])
def test_the_port_agrees(n, k):
    from repro_torch.ec.rs import RSCode

    code = RSCode(n, k)
    assert np.array_equal(np.array(ref.generator(n, k), np.uint8), code.generator)
    data = torch.randint(0, 256, (k, 513), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(n))
    cw = code.encode(data)
    for i, p in enumerate(ref.encode_parity(n, k, data)):
        assert torch.equal(cw[k + i], p)


def test_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path

    tree = ast.parse(Path(ref.__file__).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert names <= {"__future__", "functools", "numpy", "torch"}
