"""Launch layer of the port: the multi-round federated loop
(``train.federated_train_loop``) and the federated LM trainer
(``federated_lm``)."""
