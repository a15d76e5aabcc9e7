"""Domain decomposition: a 3-D grid cut into blocks over a logical mesh of
shards (port of ``levelsetfortran_tpu/parallel``)."""
