"""The systems under test, one module per ``system`` of a configuration.

A new cell is added as new files and new entries of ``BENCHMARK.json``,
and changes no file that is there. What ``harness.run_cell`` asks of each
part:

* **The system**, ``systems/<system>.py``, named by the configuration's
  ``system``: ``System(config, traffic, devices, spans, log)``, then
  ``prepare(seed)`` (loads the program, makes the inputs from the seed and
  sets ``queries``, the pool whose first axis is the query: ``[P, d]``, or
  ``[P, 1 + Q, d]`` for a primary row and a token set), ``ingest()``
  (seconds of a timed ingest, or None), ``queries``, ``call(qs)`` (one
  call's answers, one a query), ``count_bad(out, b, limit)`` (its short
  or missing answers), ``answer_rows(answer)`` (``(rows [k] int64, scores
  [k] float64)``), ``reference_blocks()`` (``(blocks, device)``: the
  inputs as the reference reads them, a list of ``(first_row, tensor)``),
  ``counters()``, ``shape()`` (the sizes the readers' arithmetic takes)
  and ``close()``. ``spans.wrap(name, fn)`` times a layer's calls.
* **The reference**, ``reference/<reference>.py``, named by the
  configuration's ``reference``: plain torch or NumPy that imports nothing
  of the program. ``top_k(blocks, queries, k, precision="f64"|"tf32",
  device=None)`` gives ``(rows [b, k], scores [b, k])``; ``"tf32"`` is
  the control, the precision below the configuration's. ``scores_of(blocks,
  queries, rows)`` gives what ``numbers(rows, scores, truth_rows,
  truth_scores, exact)`` needs of the returned rows; ``numbers`` gives the
  readings that the configuration's ``checks`` hold, among them
  ``score_err``, the largest gap between a returned score and its exact
  value, which the control has to drive above rounding.
* **The faults**, ``faults/<system>.py``: ``FAULTS``, at least ``stale``,
  ``half`` and ``altered`` (``faults/__init__.py``).
* **The configuration**, ``configs/<name>.json``, may state its own tiny
  size for the CPU tests, ``"tiny": {"config": {...}, "traffic": {...}}``,
  merged over the tests' general rules; a run on the card reads no such
  key.
* **The entries**: the configuration and the workload; the cell's name
  appended to the ``workloads`` list of each end-to-end metric it reports
  (``qps``, and ``ingest_s`` where it times an ingest); its per-layer
  metrics as new entries with their own ``workloads`` list, each read by a
  new ``layer_metrics/<name>.py``. A traffic mix of its own is a new
  ``traffic/<name>.json``, and a load loop of its own a new
  ``loops/<loop>.py``.

``tests/new_cell/`` holds a cell made this way, and
``tests/test_bench_new_cell.py`` runs it.
"""
