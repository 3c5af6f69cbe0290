"""The comparisons on made-up readings: the CTC alignment gap, and
Paraformer's count check with its near-tie excuse."""
import numpy as np
import torch

from benchmark.families import common, paraformer, sensevoice
from benchmark.lib import harness
from benchmark.reference import nets


def ctc_gap(logits, ids, blank=0):
    logits = torch.as_tensor(logits, dtype=torch.float32)
    labels = np.full(2 * len(ids) + 1, blank)
    labels[1::2] = ids
    gaps = (logits.max(-1).values[:, None] - logits[:, labels]).numpy()
    return sensevoice.alignment_gap(gaps, np.asarray(ids), blank, labels)


def test_alignment_gap():
    # frames argmax: 3 3 0 5 5 -> collapses to [3, 5]
    lg = np.zeros((5, 8))
    for t, (k, v) in enumerate([(3, 2.0), (3, 2.0), (0, 1.0), (5, 3.0),
                                (5, 3.0)]):
        lg[t, k] = v
    assert ctc_gap(lg, [3, 5]) == 0.0
    # a second 3 needs a blank between the two: frame 1's blank gap
    assert ctc_gap(lg, [3, 3, 5]) == 2.0
    # a token no frame offers reads the least gap of a frame it can take
    assert ctc_gap(lg, [3, 7, 5]) == 1.0
    # more tokens than frames can carry: no alignment
    assert ctc_gap(lg[:2], [1, 2, 3]) == np.inf


def family():
    return paraformer.Family(harness.load_json(
        harness.BENCH / "configs" / "paraformer-large.json"))


def out(count, near):
    logits = torch.zeros(count, 10)
    logits[:, 4] = 1.0
    return nets.ParaformerOut(logits, None, 0.0, near)


def test_counts_and_near_ties():
    fam = family()
    tie = fam.node["cif_tie"]
    read = common.Readings()
    fam._compare({"ids": np.full(5, 4)}, out(5, []), read)
    assert read.values["argmax_gap"] == 0.0
    assert "token_count_off" not in read.values
    fam._compare({"ids": np.full(4, 4)}, out(5, []), read)
    assert read.values["token_count_off"] == 1
    read = common.Readings()
    fam._compare({"ids": np.full(4, 4)}, out(5, [(tie / 2, 3)]), read)
    assert read.values["count_at_tie"] == 1
    assert "token_count_off" not in read.values
    read = common.Readings()
    fam._compare({"ids": np.full(4, 4)}, out(5, [(tie * 2, 3)]), read)
    assert read.values["token_count_off"] == 1
    read = common.Readings()
    ids = np.full(200, 4)
    ids[150] = 7      # past the tie's reach: not compared
    fam._compare({"ids": ids}, out(201, [(tie / 2, 190)]), read)
    assert read.values["argmax_gap"] == 0.0
    ids[50] = 7
    fam._compare({"ids": ids}, out(201, [(tie / 2, 190)]), read)
    assert read.values["argmax_gap"] == 1.0
