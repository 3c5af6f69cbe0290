"""The port's ChineseITN against the JAX package's rule engine on the
inputs of tests/test_itn.py (every string handed to normalize() there,
collected from its source), enabled and disabled: equal outputs."""
import ast
from pathlib import Path

import pytest

from asr2pass_tpu.text import itn as jitn
from asr2pass_tpu_torch.text import itn as titn


def _inputs():
    tree = ast.parse((Path(__file__).parent / "test_itn.py").read_text())
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("normalize", "parse_zh_number")
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            found.append(node.args[0].value)
    return sorted(set(found))


_TEXTS = _inputs()


def test_inputs_collected():
    assert len(_TEXTS) >= 30


@pytest.mark.parametrize("text", _TEXTS)
def test_normalize_matches_jax(text):
    assert (titn.ChineseITN().normalize(text)
            == jitn.ChineseITN().normalize(text))
    assert titn.ChineseITN(enable=False).normalize(text) == text


@pytest.mark.parametrize("text", _TEXTS)
def test_parse_zh_number_matches_jax(text):
    assert titn.parse_zh_number(text) == jitn.parse_zh_number(text)
