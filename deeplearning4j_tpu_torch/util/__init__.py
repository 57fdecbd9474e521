"""Host-side utilities of the port (counterpart:
``deeplearning4j_tpu/util``): crash forensics and model persistence."""
