from repro_torch.data.synthetic import (PAPER_DATASETS, TokenStream,
                                        make_dataset_like, make_lasso_data,
                                        make_token_batch)

__all__ = ["PAPER_DATASETS", "make_dataset_like", "make_lasso_data",
           "make_token_batch", "TokenStream"]
