"""The three core networks and the restore pipeline (counterpart of
``marconet_tpu.models``)."""
