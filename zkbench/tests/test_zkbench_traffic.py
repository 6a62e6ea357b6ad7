"""The traffic generator: a seed gives the same calls, every seed the
same sizes."""

import itertools

import pytest

from zkbench import manifest, traffic

MIXES = ["single", "batch4"]


def take(mix, msg_len, seed, n=5, stream="window"):
    return list(itertools.islice(
        traffic.calls(mix, msg_len, seed, stream), n))


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_repeats_exactly(name):
    mix = traffic.load_mix(manifest.HERE / "traffic" / f"{name}.json")
    seed = 2**31 + 12345
    assert take(mix, 16, seed) == take(mix, 16, seed)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_change_contents_not_sizes(name):
    mix = traffic.load_mix(manifest.HERE / "traffic" / f"{name}.json")
    a, b = take(mix, 64, 1), take(mix, 64, 2**40 + 1)
    assert a != b
    for x, y in zip(a, b):
        assert [len(m) for m in x.messages] == [len(m) for m in y.messages]
        assert len(x.messages) == mix.messages_per_call
        assert len(x.key) == len(y.key) == 16
        assert x.index == y.index


def test_warmup_stream_is_its_own():
    mix = traffic.load_mix(manifest.HERE / "traffic" / "single.json")
    assert take(mix, 16, 7, stream="warmup") != take(mix, 16, 7)


def test_mixes_read():
    single = traffic.load_mix(manifest.HERE / "traffic" / "single.json")
    batch = traffic.load_mix(manifest.HERE / "traffic" / "batch4.json")
    assert (single.call, single.messages_per_call) == ("encrypt", 1)
    assert (batch.call, batch.messages_per_call) == ("encrypt_batch", 4)


@pytest.mark.parametrize("text", [
    '{"call": "encrypt", "messages_per_call": 2}',      # one a call
    '{"call": "encrypt", "messages_per_call": 1, "loop": "open"}',
])
def test_a_bad_mix_is_refused(tmp_path, text):
    p = tmp_path / "bad.json"
    p.write_text(text)
    with pytest.raises(ValueError):
        traffic.load_mix(p)
