"""The port's four example scripts (``examples/*_torch.py``) run end to
end on the CPU at a small scale, through their ``main``."""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples")

RUNS = {
    "quickstart_torch": ["--device", "cpu", "--scale", "0.02", "--rounds", "1"],
    "hfl_healthcare_torch": ["--device", "cpu", "--scale", "0.02", "--rounds", "1"],
    "hfl_lm_training_torch": ["--device", "cpu", "--scale", "0.05", "--rounds", "1", "--model", "moe"],
    "serve_llm_torch": ["--device", "cpu", "--tokens", "4", "--arch", "jamba-1.5-large-398b"],
}
EXPECT = {
    "quickstart_torch": "eara-sca   acc/round:",
    "hfl_healthcare_torch": "centralized benchmark acc:",
    "hfl_lm_training_torch": "done: ",
    "serve_llm_torch": "generated token ids (row 0):",
}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, capsys):
    _load(name).main(RUNS[name])
    assert EXPECT[name] in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_defaults_to_the_card(name):
    """Without CUDA the default device raises: the scripts never fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    args = [a for a in RUNS[name] if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(name).main(args)
