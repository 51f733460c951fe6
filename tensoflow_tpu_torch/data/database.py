"""Scene databases of the PyTorch port: the toy branch of
tensoflow_tpu/data/database.py (the procedural scene needs no files).

The dataset-backed adapters (tensoSDF/nerf/tensoIR/orb/colmap) are not
ported yet; ``parse_database_name`` raises for them.
"""
from __future__ import annotations

import abc
import random
from typing import List, Tuple


class BaseDatabase(abc.ABC):
    """(ref: database.py:20-45)"""

    def __init__(self, database_name: str):
        self.database_name = database_name

    @abc.abstractmethod
    def get_image(self, img_id): ...

    @abc.abstractmethod
    def get_K(self, img_id): ...

    @abc.abstractmethod
    def get_pose(self, img_id): ...

    @abc.abstractmethod
    def get_img_ids(self): ...

    @abc.abstractmethod
    def get_depth(self, img_id): ...

    def get_mask(self, img_id):
        return None

    def get_normal(self, img_id):
        return None

    def get_albedo(self, img_id):
        raise NotImplementedError


def parse_database_name(database_name: str, dataset_dir: str, isTest=False,
                        isWhiteBG=False) -> BaseDatabase:
    """(ref: database.py:804-822) — toy scenes only in the port."""
    from .toy import ToyDatabase
    dtype = database_name.split('/')[0]
    if dtype != 'toy':
        raise NotImplementedError(
            f'{database_name}: only toy/* databases are ported')
    return ToyDatabase(database_name, dataset_dir, isTest=isTest,
                       isWhiteBG=isWhiteBG)


def get_database_split(database: BaseDatabase, split_type='validation',
                       split_manul=False, split_borderline=100
                       ) -> Tuple[List, List]:
    """(ref: database.py:824-844)"""
    if split_manul:
        img_ids = database.get_img_ids()
        train_ids = img_ids[:split_borderline]
        test_ids = img_ids[split_borderline:]
        if len(test_ids) > 10:
            test_ids = test_ids[::50]
        else:
            test_ids = test_ids[::4]
        return train_ids, test_ids
    if split_type == 'validation':
        random.seed(6033)
        img_ids = list(database.get_img_ids())
        random.shuffle(img_ids)
        return img_ids[1:], img_ids[:1]
    raise NotImplementedError(split_type)
