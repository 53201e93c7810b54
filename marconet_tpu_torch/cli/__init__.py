"""Command-line tools of the port (counterparts of the JAX package's
``tools/test_sr.py``, ``tools/test_w.py``, ``tools/serve_demo.py``,
``tools/train.py``, ``tools/eval_metrics.py``, ``tools/parity_report.py``,
``tools/crop_bg_patches.py``, ``tools/profile_sr.py`` and
``tools/syndata_demo.py``).

Each runs as ``python -m marconet_tpu_torch.cli.<name>``, keeps the JAX
tool's flags and defaults and adds ``--device`` (default ``cuda``) where
it runs a network. Images are read as the JAX tools read them through
``cv2.imread`` (``utils/imread.py``: PNG, JPEG and BMP, chosen by their
magic bytes; a file that cannot be read is named in a warning and
skipped) and written with the port's PNG codec (``utils/png.py``) and GIF
writer (``utils/gif.py``).
"""
