"""MovieLens helpers (host copy of :mod:`polara_tpu.datasets.movielens`'s
``get_split_genres``; the archive loaders are not ported yet).

Pure pandas frame methods: nothing here imports pandas itself, so the
package loads without it.
"""
from __future__ import annotations


def get_split_genres(genres_data):
    """Explode the ``|``-separated genre strings of a
    ``movieid/movienm/genres`` frame into one row per (movie, genre) pair
    (reference ``movielens.py:86-94``)."""
    exploded = genres_data.assign(
        genreid=genres_data["genres"].str.split("|"))
    exploded = exploded.explode("genreid", ignore_index=True)
    return exploded[["movieid", "movienm", "genreid"]]
