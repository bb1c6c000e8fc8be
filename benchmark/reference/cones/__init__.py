"""The distance from each cone kind and from its dual, one module per kind,
named as the port names its cone class (``ZeroConeT``, ...), so that a
generator's ``[class name, arguments]`` pair finds its module.  Each module
has ``rows(*arguments)``, the rows the cone covers, and ``distance_sq(seg,
*arguments, dual)``, the squared Euclidean distance of each row of ``seg``
[L, rows] from the cone, or with ``dual`` from its dual cone."""
