"""The benchmark's general harness: one runner per kind of traffic
(``train``, ``serve``), the trace reduction, the shared checks."""
