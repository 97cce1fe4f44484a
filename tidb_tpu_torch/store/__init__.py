from tidb_tpu_torch.store.storage import MockStorage, new_mock_storage

__all__ = ["MockStorage", "new_mock_storage"]
