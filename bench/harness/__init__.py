"""The benchmark harness of the port (`repro_torch`), driven by data.

`BENCHMARK.json` at the repository root names the cells, configurations
and metrics; the harness finds everything else by those names:

  bench/configs/<config>.json     a deployment: the job, its expected DAG
  bench/traffic/<traffic>.json    a traffic mix, read by `traffic.drive`
  bench/metrics/<metric>.py       a metric's reader, or <family>.py for
                                  every metric <family>.<cells>
  bench/limits/<workload>.json    the limits of the cell's comparisons

  spec      BENCHMARK.json and the files it names
  job       the DAG of a configuration, and its raw arrays
  traffic   the general generator: plan requests from a traffic file
  probe     wrappers set from outside the program, and what they record
  trace     the device's profile over the traced window
  roofline  the H100's peaks and the kernels' bytes and operations
  check     the comparison with the plain reference that decides `correct`
  cell      one run of one cell, start to end
"""
