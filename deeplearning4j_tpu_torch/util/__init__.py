"""Host-side utilities of the port (counterpart:
``deeplearning4j_tpu/util``): crash forensics, model persistence, test
resources and archives, and sharded checkpoints."""
