"""Command-line tools of the port (counterparts of the JAX package's
``tools/test_sr.py``, ``tools/test_w.py``, ``tools/serve_demo.py``,
``tools/train.py`` and ``tools/eval_metrics.py``).

Each runs as ``python -m marconet_tpu_torch.cli.<name>``, keeps the JAX
tool's flags and defaults, adds ``--device`` (default ``cuda``) where it
runs a network, and reads and writes images with the port's PNG codec
(``utils/png.py``): input is PNG only, other files are named in a warning
and skipped.
"""
