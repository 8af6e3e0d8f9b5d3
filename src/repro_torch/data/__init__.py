from repro_torch.data.synthetic import (PAPER_DATASETS, make_dataset_like,
                                        make_lasso_data)

__all__ = ["PAPER_DATASETS", "make_dataset_like", "make_lasso_data"]
