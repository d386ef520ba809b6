"""Load loops, one module per ``loop`` that a traffic file names.

``<name>.py`` holds ``Loop(sut, pool, traffic, log)``: ``sut.call(qs)``
answers a slice of the query ``pool`` (a list of answers, one a query),
``sut.count_bad(out, len(qs), limit)`` counts its short answers, and the
traffic file's keys shape the load. ``Loop.run(seconds, reservoir=None,
min_calls=1)`` offers the load for ``seconds`` (and at least
``min_calls`` calls), hands each call's answers to ``reservoir.offer(first
query's index in the pool, answers)``, and returns ``(seconds from the
first call to the end of the last, calls, queries answered, queries
failed, [latency s of each query or call])``.
"""
