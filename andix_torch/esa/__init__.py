"""Enhanced-suffix-array subsystem of the port: joint text layout
(``joint``, a copy of ``andix``'s), prefix-doubling suffix array
(``doubling``), rank-level LCP (``lcp``), range-min structure (``rmq``),
flag-scan kernel (``scans``), matching statistics (``matchstats``), the
block backend (``backend``), the per-subject index (``subject_index``)
and the numpy suffix array (``sa_numpy``, a copy of ``andix``'s)."""
