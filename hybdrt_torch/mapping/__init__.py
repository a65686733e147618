"""Map-level code of the port: the map class and the group resolve
(``drtmd``, ``resolve``) and the post-fit host pipeline (``ndx``, ``nddata``,
``surface``, ``extrema``)."""
