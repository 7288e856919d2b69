"""The reader of `delaunay_wait_s`, the frame's wait at the SPG for the
triangulation started beside its other stages."""
from portbench.harness import manifest


def test_delaunay_wait_reads_the_median_wait_and_nothing_without_it():
    """`delaunay_wait_s`: the median over the timed frames of the wait at
    the SPG for the started triangulation; None for clouds without one (a
    room, a scan, a frame of a program that triangulates in line)."""
    read = manifest.reader("delaunay_wait_s")
    frames_ = [{"times": {"delaunay": 9.0, "delaunay_wait": w}}
               for w in (6.5, 6.0, 7.0, 5.5)]
    assert read({"clouds": frames_, "trace": None}) == 6.25
    # the profiled frame (the first of a traced window) is left out
    assert read({"clouds": frames_, "trace": {}}) == 6.0
    inline = {"clouds": [{"times": {"ssp_embed": 1.1, "delaunay": 9.0}}],
              "trace": None}
    room = {"clouds": [{"times": {"read_s3dis": 2.0, "partition_cloud.spg":
                                  0.7}}], "trace": None}
    assert read(inline) is None and read(room) is None
