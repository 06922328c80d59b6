"""pragma_dsp_tpu — a batched DSP/SDR framework in JAX, run on the GPU.

Built from scratch with the capabilities of pragma-dsp (see SURVEY.md),
re-designed for accelerators: batched split-complex FFTs (cuFFT through
``jnp.fft`` on the GPU), batched windowed-spectrum ops, and
sharded/streaming pipelines over device meshes. The package name is an
import path kept from the system's first target.

The API ladder mirrors the reference (PLAN.md:16-32 of the reference):

* beginner  — ``pragma_dsp_tpu.spectrum`` (root export, like src/index.ts:1)
* power     — ``pragma_dsp_tpu.xform`` (windows, magnitude/phase, shifts)
* expert    — ``pragma_dsp_tpu.core`` (split-complex arrays, FFT plans)
* fluent    — ``pragma_dsp_tpu.fluent`` (chaining with checked inverse)
* streaming — ``pragma_dsp_tpu.stream`` (the Effect-rung analogue)
* scale     — ``pragma_dsp_tpu.parallel`` (meshes, collectives, dist-FFT)
"""

from .public import SpectrumPeak, SpectrumResult, spectrum

__version__ = "0.1.0"

__all__ = ["spectrum", "SpectrumPeak", "SpectrumResult", "__version__"]
