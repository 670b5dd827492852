"""Launch layer of the port: the multi-round federated loop
(``train.federated_train_loop``), the federated LM trainer
(``federated_lm``), the serving loop (``serve``) and the host helpers
(``hostenv``)."""
