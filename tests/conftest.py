"""Test-session configuration.

Tests run on CPU with 8 virtual devices so the multi-chip sharding layer is
exercised without a pod (the SURVEY.md §4 analogue of the reference's
"test multi-node without a real cluster": XLA_FLAGS device-count spoofing).
x64 is enabled so CPU runs can meet the reference's f64 tolerances; GPU
runs use f32 + SNR bounds instead (see utils/fixtures.py and
chip_smoke.py, which is how the card itself is checked).

Env vars MUST be set before jax is imported, hence the top of conftest.
"""

import os

# Hard override: tests run hermetically on the host CPU, whatever
# JAX_PLATFORMS the environment sets.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from pragma_dsp_tpu.utils.fixtures import fixtures_dir, load_json  # noqa: E402


@pytest.fixture(scope="session")
def unit_fixtures():
    return load_json(os.path.join(fixtures_dir(), "unit_fixtures.json"))


def _reallife(name):
    return load_json(os.path.join(fixtures_dir(), "reallife", f"{name}.json"))


@pytest.fixture(scope="session")
def pure_sine_refs():
    return _reallife("pure_sine")


@pytest.fixture(scope="session")
def cosine_refs():
    return _reallife("cosine")


@pytest.fixture(scope="session")
def multi_tone_refs():
    return _reallife("multi_tone")


@pytest.fixture(scope="session")
def chirp_refs():
    return _reallife("chirp")


@pytest.fixture(scope="session")
def special_refs():
    return _reallife("special")


@pytest.fixture(scope="session")
def windows_dsp_refs():
    return _reallife("windows_dsp")


@pytest.fixture(scope="session")
def all_signal_refs(pure_sine_refs, cosine_refs, multi_tone_refs, chirp_refs,
                    special_refs):
    cases = []
    for group in (pure_sine_refs, cosine_refs, multi_tone_refs, chirp_refs,
                  special_refs):
        cases.extend(group["cases"])
    return cases
