"""PNG decodes a pair in the flow stage: the `frames` attr of the
`flow.decode` spans inside the traced chunks (`flow.iter` spans), summed,
over the chunks' pairs (program spans). None where a decode span carries
no count (a program that decodes every padded pair's two frames)."""

from cvd_bench.program_spans import flow_iters


def _decodes(tree):
    """The `flow.decode` spans inside `tree`, at any depth."""
    for c in tree["children"]:
        if c["name"] == "flow.decode":
            yield c
        yield from _decodes(c)


def read(run):
    iters = flow_iters(run)
    if iters is None:
        return None
    frames = [d["attrs"].get("frames") for it in iters for d in _decodes(it)]
    pairs = sum(it["attrs"].get("pairs", 0) for it in iters)
    if not frames or None in frames or not pairs:
        return None
    return sum(frames) / pairs
