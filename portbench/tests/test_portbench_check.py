"""The check's sample: it spans many requests, takes at most a few
positions of each, always holds the longest request and each request's
last position, and is drawn from the seed alone."""

from dataclasses import dataclass, field

from portbench import check


@dataclass
class Req:
    index: int
    prompt_ids: list
    output_ids: list
    finished: bool = True

    @property
    def prompt_len(self):
        return len(self.prompt_ids)


def requests(n=40):
    # request 7 is the longest; request 3 was cut by the close
    out = []
    for i in range(n):
        prompt = 100 + (900 if i == 7 else 10 * i)
        out.append(Req(i, [1] * prompt, list(range(20 + 13 * (i % 9))),
                       finished=i != 3))
    return out


def test_sample_spans_requests_with_a_cap_each():
    reqs = requests()
    sample = check.draw_sample(reqs, 2**31 + 99)
    assert len(sample) == check.REQUESTS
    assert len({r.index for r, _ in sample}) == check.REQUESTS
    assert sample[0][0].index == 7
    assert all(r.finished for r, _ in sample)
    for r, at in sample:
        n = len(r.output_ids)
        assert len(at) == min(n, check.TOKENS_EACH)
        assert at == sorted(set(at)) and at[-1] == n - 1
        assert 0 <= at[0]


def test_sample_by_seed():
    reqs = requests()
    pick = lambda s: [(r.index, at) for r, at in check.draw_sample(reqs, s)]
    assert pick(5) == pick(5)
    assert pick(5) != pick(6)


def test_few_requests_all_taken():
    reqs = requests(5)
    sample = check.draw_sample(reqs, 1)
    assert sorted(r.index for r, _ in sample) == [0, 1, 2, 4]
