"""Model families of the port: Naive Bayes and brute-force KNN."""
