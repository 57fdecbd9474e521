"""Framework import (counterpart: ``deeplearning4j_tpu/modelimport``; ref:
deeplearning4j-modelimport + nd4j/samediff-import)."""
