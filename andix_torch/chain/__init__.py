"""Anchor chaining: subject tables, the flat chain-walk kernel and the
count-in-loop replay kernel (``replay_device``), the search walk over the
subject index (``walk_sx``), the segmented walk's host loop
(``segdrive``, compiled), host counting from anchor events (``events``)
and the exact Python replay (``replay_py``); the last two are copies of
``andix``'s."""

from .replay_py import dist_anchor_replay  # noqa: F401
