"""The benchmark's harness of the port ``raytracingtest_tpu_torch``: the
yardstick (traffic, reference, work counts, trace reading) that the cells'
data files drive."""
