"""The traffic generator is a pure function of the seed."""
from harness import traffic

BIG = 2 ** 33 + 12345                 # wider than 32 bits


def test_decode_start_is_pure():
    a = traffic.decode_start(BIG, 3, 16, 49152)
    assert (a == traffic.decode_start(BIG, 3, 16, 49152)).all()
    assert (a != traffic.decode_start(BIG, 4, 16, 49152)).any()
    assert (a != traffic.decode_start(BIG + 1, 3, 16, 49152)).any()
    assert a.shape == (16,) and a.min() >= 0 and a.max() < 49152
