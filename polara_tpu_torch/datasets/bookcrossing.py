"""BookCrossing loader (host copy of
:mod:`polara_tpu.datasets.bookcrossing`; reference
``polara/datasets/bookcrossing.py:10-49``).  pandas loads on the first
call."""
from __future__ import annotations

from io import BytesIO
from zipfile import ZipFile

from polara_tpu_torch.datasets.movielens import fetch_url

BX_URL = ("http://www2.informatik.uni-freiburg.de/~cziegler/BX/"
          "BX-CSV-Dump.zip")


def _normalize(name: str) -> str:
    return name.lower().replace("book-", "").replace("-id", "id")


def get_bookcrossing_data(local_file=None, get_ratings: bool = True,
                          get_users: bool = False, get_books: bool = False,
                          allow_download: bool = False):
    """Parse the BX-CSV-Dump archive into ratings/users/books frames with
    normalized lowercase column names."""
    import pandas as pd

    if local_file is None:
        if not allow_download:
            raise ValueError("no local_file given; pass allow_download=True "
                             "to fetch the BX dump")
        local_file = fetch_url(BX_URL)

    ratings = users = books = None
    delimiter = ";"
    with ZipFile(local_file) as zfile:
        zip_files = pd.Series(zfile.namelist())

        def member(token):
            return zip_files[zip_files.str.contains(token, case=False)].iat[0]

        if get_ratings:
            raw = zfile.read(member("ratings"))
            ratings = pd.read_csv(BytesIO(raw), sep=delimiter, header=0,
                                  engine="c", encoding="unicode_escape")
        if get_users:
            with zfile.open(member("users")) as zdata:
                users = pd.read_csv(zdata, sep=delimiter, header=0,
                                    engine="c", encoding="unicode_escape")
        if get_books:
            with zfile.open(member("books")) as zdata:
                books = pd.read_csv(zdata, sep=delimiter, header=0,
                                    engine="c", quoting=1, escapechar="\\",
                                    encoding="unicode_escape",
                                    usecols=["ISBN", "Book-Author",
                                             "Publisher"])

    res = [frame.rename(columns=_normalize)
           for frame in (ratings, users, books) if frame is not None]
    return res[0] if len(res) == 1 else res
