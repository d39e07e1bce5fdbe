"""Anchor chaining: subject tables and the flat chain-walk kernel
(``replay_device``), the search walk over the subject index
(``walk_sx``), the segmented walk's host loop (``segmented``), host
counting from anchor events (``events``) and the exact Python replay
(``replay_py``); the last three are copies of ``andix``'s."""
